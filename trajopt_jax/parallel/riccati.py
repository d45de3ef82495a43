"""Batch-native exact-LQR (Riccati) solves.

The host class (solvers/riccati.Riccati, riccati/riccati.py:8-161) is a single
jitted program per problem; this module solves a BATCH of Riccati problems with
the backward pass as one Pallas launch (core/pallas_lqr.pallas_riccati_backward —
the homogeneous-coordinate reduction onto the iLQR kernel) or as vmapped scans,
and the forward rollouts vmapped — the exact-LQR analogue of the batch-native
iLQR path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from ..core.diff import linearize_dynamics, quadratize_cost_abs
from ..core.scan_lqr import riccati_backward
from ..core.types import LinearDynamics, LinearPolicy
from ..solvers.common import make_weighting, rollout_feedback


def make_riccati_solver_batched(
    env,
    nb_steps: int,
    activation: dict | None = None,
    backward: str = "scan",
    interpret: bool = False,
):
    """Build ``solve(x0s (N, dx)) -> (policy, states, actions, costs)`` — a batch
    of full Riccati solves (linearize once around the zero reference, one exact
    backward sweep, one feedback rollout each, riccati/riccati.py:148-161).

    ``backward='pallas'`` runs all N backward passes as one Pallas launch
    (GPU, or any backend with ``interpret=True``); ``'scan'`` vmaps the
    sequential kernel (any backend).
    """
    T = nb_steps
    weighting = make_weighting(nb_steps, activation)

    def expand(x0):
        xref = jnp.zeros((T + 1, env.dm_state), x0.dtype).at[0].set(x0)
        uref = jnp.zeros((T, env.dm_act), x0.dtype)
        dyn = linearize_dynamics(env.dynamics, xref[:T], uref)
        cost = quadratize_cost_abs(env.cost, xref, uref, weighting)
        return cost, dyn

    if backward == "pallas":
        from ..core.pallas_lqr import pallas_riccati_backward

        def bwd(cost, dyn):
            return pallas_riccati_backward(
                cost, dyn.A, dyn.B, dyn.c, interpret=interpret
            )
    elif backward == "scan":

        def bwd(cost, dyn):
            def one(c, d):
                ctl, _ = riccati_backward(c, d)
                return ctl

            ctl = jax.vmap(one)(cost, dyn)
            div = ~jnp.all(
                jnp.isfinite(ctl.K.reshape(ctl.K.shape[0], -1)), axis=1
            )
            return ctl, div
    else:
        raise ValueError(
            f"unknown backward impl {backward!r}; available: 'scan', 'pallas'"
        )

    def solve(x0s: Array):
        cost, dyn = jax.vmap(expand)(x0s)
        ctl, diverged = bwd(cost, dyn)
        states, actions, costs = jax.vmap(
            lambda c, x0: rollout_feedback(env, c, x0, weighting)
        )(ctl, x0s)
        return ctl, states, actions, costs, diverged

    return solve
