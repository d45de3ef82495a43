"""Extended LQR (Todorov / van den Berg style).

JAX re-implementation of ``trajopt.elqr.eLQR`` (elqr/elqr.py:8-201): maintains
quadratic *cost-to-go* and *cost-to-come* value functions; the forward LQR pass
linearizes the **inverse** dynamics and propagates cost-to-come, the backward pass
linearizes the forward dynamics and propagates cost-to-go; at every step the reference
state is re-chosen as the minimizer of the summed quadratics.

Unlike Riccati/iLQR, the linearization points are data-dependent *inside* the sweep
(elqr.py:67-110), so jacobians/hessians are evaluated inside the ``lax.scan`` bodies —
one compiled program per sweep instead of O(T) autograd calls per sweep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.diff import quadratize_cost_elqr
from ..core.types import LinearPolicy, QuadraticValue
from .common import make_weighting


# ---------------------------------------------------------------------- pure sweeps
def elqr_cost_eval(env, x, u):
    """cost with u_last = 0, a = 1 (elqr/objects.py:53-54)."""
    return env.cost(x, u, jnp.zeros(env.dm_act, x.dtype), 1.0)


def _lin_about(f, x, u):
    A = jax.jacfwd(f, argnums=0)(x, u)
    B = jax.jacfwd(f, argnums=1)(x, u)
    c = f(x, u) - A @ x - B @ u
    return A, B, c


def elqr_rollout(env, ctl, x0):
    """Deterministic rollout under u = kff + K x with elqr cost (elqr.py:53-65)."""

    def step(x, inp):
        K, kff = inp
        u = kff + K @ x
        c = elqr_cost_eval(env, x, u)
        xn = env.dynamics(x, u)
        return xn, (x, u, c)

    x_T, (xs, us, cs) = lax.scan(step, x0, (ctl.K, ctl.kff))
    c_T = elqr_cost_eval(env, x_T, jnp.zeros(env.dm_act, x0.dtype))
    return (
        jnp.concatenate([xs, x_T[None]], axis=0),
        us,
        jnp.concatenate([cs, c_T[None]], axis=0),
    )


def elqr_forward_lqr(env, state, ctl, goV, gov):
    """Forward sweep propagating cost-to-come via inverse-dynamics linearization
    (elqr/elqr.py:67-110)."""

    def step(carry, inp):
        x, comeV, comev, comev0 = carry
        K_t, kff_t, goV_n, gov_n = inp

        u = kff_t + K_t @ x
        xn = env.dynamics(x, u)

        A, B, c = _lin_about(env.inverse_dynamics, xn, u)
        Cxx, Cuu, Cxu, cx, cu, c0 = quadratize_cost_elqr(env.cost, x, u)

        M = Cxx + comeV
        Qxx = A.T @ M @ A
        Quu = B.T @ M @ B + B.T @ Cxu + Cxu.T @ B + Cuu
        Qux = B.T @ M @ A + Cxu.T @ A
        qx = A.T @ M @ c + A.T @ (cx + comev)
        qu = B.T @ M @ c + Cxu.T @ c + B.T @ (cx + comev) + cu
        q0 = 0.5 * c @ M @ c + c @ (cx + comev) + c0 + comev0

        Quu_inv = jnp.linalg.inv(Quu)
        iK = -Quu_inv @ Qux
        ikff = -Quu_inv @ qu

        comeV_n = Qxx - Qux.T @ Quu_inv @ Qux
        comev_n = qx - Qux.T @ Quu_inv @ qu
        comev0_n = q0 - 0.5 * qu @ Quu_inv @ qu

        x_new = -jnp.linalg.inv(goV_n + comeV_n) @ (gov_n + comev_n)
        return (x_new, comeV_n, comev_n, comev0_n), (
            iK, ikff, comeV_n, comev_n, comev0_n
        )

    dx = env.dm_state
    init = (
        state,
        1e-16 * jnp.eye(dx, dtype=state.dtype),
        jnp.zeros(dx, state.dtype),
        jnp.asarray(0.0, state.dtype),
    )
    inputs = (ctl.K, ctl.kff, goV[1:], gov[1:])
    (state_out, *_), (iK, ikff, comeVs, comevs, comev0s) = lax.scan(
        step, init, inputs
    )

    comecost = QuadraticValue(
        V=jnp.concatenate([init[1][None], comeVs], axis=0),
        v=jnp.concatenate([init[2][None], comevs], axis=0),
        v0=jnp.concatenate([init[3][None], comev0s], axis=0),
    )
    return state_out, LinearPolicy(K=iK, kff=ikff), comecost


def elqr_backward_lqr(env, state, ictl, comeV, comev, comev0):
    """Backward sweep propagating cost-to-go via forward-dynamics linearization
    (elqr/elqr.py:112-160)."""
    du = env.dm_act

    # terminal quadratization at (state, 0) — elqr.py:113-122
    Cxx_T, _, _, cx_T, _, c0_T = quadratize_cost_elqr(
        env.cost, state, jnp.zeros(du, state.dtype)
    )
    goV_T, gov_T, gov0_T = Cxx_T, cx_T, c0_T
    state = -jnp.linalg.inv(goV_T + comeV[-1]) @ (gov_T + comev[-1])

    def step(carry, inp):
        x, goV_n, gov_n, gov0_n = carry
        iK_t, ikff_t, comeV_t, comev_t = inp

        u = ikff_t + iK_t @ x
        xp = env.inverse_dynamics(x, u)

        A, B, c = _lin_about(env.dynamics, xp, u)
        Cxx, Cuu, Cxu, cx, cu, c0 = quadratize_cost_elqr(env.cost, xp, u)

        Qxx = Cxx + A.T @ goV_n @ A
        Quu = Cuu + B.T @ goV_n @ B
        Qux = Cxu.T + B.T @ goV_n @ A
        qx = cx + A.T @ goV_n @ c + A.T @ gov_n
        qu = cu + B.T @ goV_n @ c + B.T @ gov_n
        q0 = c0 + gov0_n + 0.5 * c @ goV_n @ c + c @ gov_n

        Quu_inv = jnp.linalg.inv(Quu)
        K = -Quu_inv @ Qux
        kff = -Quu_inv @ qu

        goV = Qxx - Qux.T @ Quu_inv @ Qux
        gov = qx - Qux.T @ Quu_inv @ qu
        gov0 = q0 - 0.5 * qu @ Quu_inv @ qu

        x_new = -jnp.linalg.inv(goV + comeV_t) @ (gov + comev_t)
        return (x_new, goV, gov, gov0), (K, kff, goV, gov, gov0)

    inputs = (ictl.K, ictl.kff, comeV[:-1], comev[:-1])
    (state_out, *_), (K, kff, goVs, govs, gov0s) = lax.scan(
        step, (state, goV_T, gov_T, gov0_T), inputs, reverse=True
    )

    gocost = QuadraticValue(
        V=jnp.concatenate([goVs, goV_T[None]], axis=0),
        v=jnp.concatenate([govs, gov_T[None]], axis=0),
        v0=jnp.concatenate([gov0s, gov0_T[None]], axis=0),
    )
    return state_out, LinearPolicy(K=K, kff=kff), gocost


class eLQR:

    def __init__(self, env, nb_steps: int, init_state, key=None):
        self.env = env
        self.nb_steps = nb_steps
        self.dm_state = env.dm_state
        self.dm_act = env.dm_act

        self.x0 = jnp.asarray(init_state)

        self.xref = jnp.zeros((nb_steps + 1, self.dm_state)).at[0].set(self.x0)
        self.uref = jnp.zeros((nb_steps, self.dm_act))

        key = jax.random.PRNGKey(0) if key is None else key
        k1, k2 = jax.random.split(key)
        # feedforward init scales as in elqr/elqr.py:44-47
        self.ctl = LinearPolicy(
            K=jnp.zeros((nb_steps, self.dm_act, self.dm_state)),
            kff=jax.random.normal(k1, (nb_steps, self.dm_act)),
        )
        self.ictl = LinearPolicy(
            K=jnp.zeros((nb_steps, self.dm_act, self.dm_state)),
            kff=1e-2 * jax.random.normal(k2, (nb_steps, self.dm_act)),
        )

        dx = self.dm_state
        zero_val = QuadraticValue(
            V=jnp.zeros((nb_steps + 1, dx, dx)).at[0].add(1e-16 * jnp.eye(dx)),
            v=jnp.zeros((nb_steps + 1, dx)),
            v0=jnp.zeros(nb_steps + 1),
        )
        self.gocost = zero_val
        self.comecost = zero_val

        self._forward_lqr = jax.jit(self._forward_lqr_impl)
        self._backward_lqr = jax.jit(self._backward_lqr_impl)
        self._rollout = jax.jit(self._rollout_impl)

    # ------------------------------------------------------------------ pieces

    def _rollout_impl(self, ctl):
        return elqr_rollout(self.env, ctl, self.x0)

    def _forward_lqr_impl(self, state, ctl, goV, gov):
        return elqr_forward_lqr(self.env, state, ctl, goV, gov)

    def _backward_lqr_impl(self, state, ictl, comeV, comev, comev0):
        return elqr_backward_lqr(self.env, state, ictl, comeV, comev, comev0)

    # ------------------------------------------------------------------ main loop
    def plot(self, show: bool = True):
        """Reference-trajectory plot (elqr/elqr.py:162)."""
        from ..utils.viz import plot_reference_trajectory

        return plot_reference_trajectory(self.xref, self.uref, show=show)

    def run(self, nb_iter: int = 10, verbose: bool = False) -> list[float]:
        from ..utils.metrics import MetricsRecorder
        self.metrics = MetricsRecorder("elqr")  # fresh history per run
        trace = []

        xs, us, cs = self._rollout(self.ctl)
        self.xref, self.uref = xs, us
        trace.append(float(jnp.sum(cs)))
        self.metrics.log(-1, ret=trace[-1])

        state = self.x0
        for it in range(nb_iter):
            state, self.ictl, self.comecost = self._forward_lqr(
                state, self.ctl, self.gocost.V, self.gocost.v
            )
            state, self.ctl, self.gocost = self._backward_lqr(
                state, self.ictl, self.comecost.V, self.comecost.v, self.comecost.v0
            )

            xs, us, cs = self._rollout(self.ctl)
            self.xref, self.uref = xs, us
            trace.append(float(jnp.sum(cs)))
            self.metrics.log(it, ret=trace[-1])
            if verbose:
                print(self.metrics.format_last())

        return trace
