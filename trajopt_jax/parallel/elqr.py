"""Fully-compiled extended LQR.

The host class (solvers/elqr.eLQR) runs the reference's outer loop
(elqr/elqr.py:179-201) on the host, dispatching three jitted sweeps per iteration.
Here the whole ``run`` — forward cost-to-come sweep (inverse-dynamics
linearization), backward cost-to-go sweep, evaluation rollout — is one ``lax.scan``
over iterations: a single XLA program, vmappable over initial states/seeds (the
reference has no batched eLQR story at all).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..core.types import LinearPolicy, QuadraticValue
from ..solvers.elqr import elqr_backward_lqr, elqr_forward_lqr, elqr_rollout


def make_elqr_solver(env, nb_steps: int, nb_iter: int = 10):
    """Build ``solve(key, x0) -> (ctl, xref, uref, trace)`` with the exact
    iteration semantics (and controller initialization) of the host class."""
    T = nb_steps
    dx, du = env.dm_state, env.dm_act

    def solve(key: Array, x0: Array):
        k1, _ = jax.random.split(key)
        ctl0 = LinearPolicy(
            K=jnp.zeros((T, du, dx), x0.dtype),
            kff=jax.random.normal(k1, (T, du), x0.dtype),
        )
        gocost0 = QuadraticValue(
            V=jnp.zeros((T + 1, dx, dx), x0.dtype).at[0].add(
                1e-16 * jnp.eye(dx, dtype=x0.dtype)
            ),
            v=jnp.zeros((T + 1, dx), x0.dtype),
            v0=jnp.zeros(T + 1, x0.dtype),
        )

        _, _, cs0 = elqr_rollout(env, ctl0, x0)
        ret0 = jnp.sum(cs0)

        def iteration(carry, _):
            state, ctl, gocost = carry
            state, ictl, comecost = elqr_forward_lqr(
                env, state, ctl, gocost.V, gocost.v
            )
            state, ctl, gocost = elqr_backward_lqr(
                env, state, ictl, comecost.V, comecost.v, comecost.v0
            )
            _, _, cs = elqr_rollout(env, ctl, x0)
            return (state, ctl, gocost), jnp.sum(cs)

        (state, ctl, gocost), trace = lax.scan(
            iteration, (x0, ctl0, gocost0), None, length=nb_iter
        )
        xs, us, _ = elqr_rollout(env, ctl, x0)
        return ctl, xs, us, jnp.concatenate([ret0[None], trace])

    return solve


def make_elqr_solver_batched(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    engine: str = "scan",
    mesh=None,
    axis_name: str = "dp",
):
    """Batch-of-problems eLQR: ``solve(keys (N,2), x0s (N, dx)) ->
    (ctl, xs, us, trace (N, nb_iter+1))``, iteration semantics identical to
    :func:`make_elqr_solver`.

    ``engine='scan'`` (the only engine) vmaps the per-instance compiled solver
    (N sequential-scan chains).

    ``mesh`` block-shards the problem axis: each device runs its own sweeps on
    its shard (the dp axis of SURVEY §2.4; the reference has no batched eLQR
    at all)."""
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; available: 'scan'")
    base = make_elqr_solver(env, nb_steps, nb_iter)

    def solve(keys: Array, x0s: Array):
        return jax.vmap(base)(keys, x0s)

    if mesh is None:
        return solve
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    return shard_map(
        solve, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        # fresh zero carries inside the solver are replicated and only
        # combine with per-shard data (same relaxation as run_mpc_batch)
        check_vma=False,
    )
