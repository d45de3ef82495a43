"""Exact finite-horizon LQR via one Riccati sweep.

JAX re-implementation of ``trajopt.riccati.Riccati`` (riccati/riccati.py:8-161):
linearize once around a reference trajectory (vmapped jacfwd instead of per-t autograd),
one backward ``lax.scan`` Riccati recursion, one forward rollout — the whole ``run`` is
a single jitted program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.diff import linearize_dynamics, quadratize_cost_abs
from ..core.scan_lqr import riccati_backward
from ..core.types import LinearPolicy, QuadraticValue
from .common import make_weighting, rollout_feedback


class Riccati:
    """API mirror of riccati/riccati.py:8 — constructor (env, nb_steps, init_state,
    activation) and ``run()`` returning the summed rollout cost."""

    def __init__(
        self,
        env,
        nb_steps: int,
        init_state,
        activation: dict | None = None,
        mesh=None,
        time_axis: str = "time",
    ):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``time_axis`` axis —
        the backward pass then runs as the horizon-block-sharded parallel Riccati
        (core/pscan_lqr.sharded_backward, ppermute-ladder halo exchange) instead
        of the sequential ``lax.scan``; results agree to solver tolerance
        (tests/test_pscan.py)."""
        self.env = env
        self.nb_steps = nb_steps
        self.mesh = mesh
        self.time_axis = time_axis

        self.dm_state = env.dm_state
        self.dm_act = env.dm_act

        mu0, sigma0 = init_state
        self.mu0 = jnp.asarray(mu0)
        self.sigma0 = jnp.asarray(sigma0)

        self.weighting = make_weighting(nb_steps, activation)

        # reference trajectory: zeros with the initial mean at t=0 (riccati.py:28-31)
        self.xref = jnp.zeros((nb_steps + 1, self.dm_state)).at[0].set(self.mu0)
        self.uref = jnp.zeros((nb_steps, self.dm_act))

        self.ctl: LinearPolicy | None = None
        self.vfunc: QuadraticValue | None = None

        self._run = jax.jit(self._run_impl)

    def _run_impl(self, xref, uref):
        T = self.nb_steps
        dyn = linearize_dynamics(self.env.dynamics, xref[:T], uref)
        cost = quadratize_cost_abs(self.env.cost, xref, uref, self.weighting)
        if self.mesh is not None:
            from ..core.pscan_lqr import sharded_backward

            ctl, vfunc = sharded_backward(cost, dyn, self.mesh, self.time_axis)
        else:
            ctl, vfunc = riccati_backward(cost, dyn)
        states, actions, costs = rollout_feedback(self.env, ctl, xref[0], self.weighting)
        return ctl, vfunc, states, actions, costs

    def run(self) -> float:
        ctl, vfunc, states, actions, costs = self._run(self.xref, self.uref)
        self.ctl, self.vfunc = ctl, vfunc
        self.xref, self.uref = states, actions
        return float(jnp.sum(costs))

    def plot(self, show: bool = True):
        """Reference-trajectory plot (riccati/riccati.py:128)."""
        from ..utils.viz import plot_reference_trajectory

        return plot_reference_trajectory(self.xref, self.uref, show=show)

    def rollout(self, key, nb_episodes: int) -> dict:
        """Batch of noisy closed-loop episodes (riccati/riccati.py:52-83)."""
        from .common import rollout_batch

        return rollout_batch(
            self.env, self.ctl, key, self.weighting, nb_episodes, stoch_policy=False
        )
