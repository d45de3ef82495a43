"""Device-mesh and multi-host setup helpers.

The reference has no distributed backend at all (SURVEY.md §2.4 — its only
parallelism is a joblib process pool in the examples); here the two parallel axes
of the framework map onto a `jax.sharding.Mesh`:

* ``dp``   — rollout/MPC episode batch (shard with ``PartitionSpec('dp')``;
  `parallel.mpc.run_mpc_batch` / `parallel.gps.run_gps_mpc_batch` take the mesh).
* ``time`` — horizon blocks for the parallel-in-time Riccati
  (`core.pscan_lqr.sharded_backward` exchanges block composites over this axis).

On a multi-host cluster, call :func:`init_multihost` once per process before
any jax computation, then build the mesh over ``jax.devices()`` (all hosts'
devices).
"""

from __future__ import annotations

import numpy as np


def init_multihost(**kwargs) -> None:
    """Standard multi-host initialization (`jax.distributed.initialize`).

    No-op when running single-process (the common single-host case), so callers
    can invoke it unconditionally.  kwargs pass through (coordinator_address,
    num_processes, process_id) for environments without automatic detection.

    A failed init is only swallowed when nothing requested a distributed run —
    no explicit kwargs and no coordinator env vars.  A genuinely misconfigured
    multi-host launch (bad coordinator address, wrong num_processes) re-raises
    instead of silently degrading to a single-process mesh.
    """
    import os

    import jax

    requested = bool(kwargs) or any(
        os.environ.get(v)
        for v in (
            "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS",
            "JAX_NUM_PROCESSES",
        )
    )
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        if requested and "already initialized" not in str(e):
            raise
        # single-process with no coordinator configured, or already initialized —
        # proceed with the local backend
        pass


def make_mesh(axis_names=("dp",), shape=None, devices=None):
    """Build a Mesh over the visible devices.

    ``shape=None`` puts all devices on the first axis.  Examples::

        mesh = make_mesh()                        # ('dp',) over all chips
        mesh = make_mesh(("dp", "time"), (4, 2))  # 4-way batch x 2-way horizon
    """
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices() if devices is None else devices)
    if shape is None:
        shape = (devices.size,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names=axis_names)
