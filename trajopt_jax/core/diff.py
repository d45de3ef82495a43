"""Batched linearization / quadratization of dynamics and costs.

Replaces every per-timestep autograd loop of the reference — e.g.
``AnalyticalLinearDynamics.taylor_expansion`` (riccati/objects.py:102-108, per-t
``autograd.jacobian`` calls) and ``AnalyticalQuadraticCost.taylor_expansion``
(riccati/objects.py:54-65, gps/objects.py:111-130, ilqr/objects.py:68-78) — with a
single ``vmap`` of ``jax.jacfwd`` / ``jax.hessian`` over the whole horizon.  One traced
call instead of O(T) Python-level autodiff calls.

Three cost-quadratization conventions exist in the reference and are kept distinct:

* ``quadratize_cost_delta``   — iLQR: raw Hessians/gradients (ilqr/objects.py:68-78).
* ``quadratize_cost_abs``     — Riccati/GPS/RGPS: ½-scaled Hessians recentred to the
  origin with residual c0 (gps/objects.py:111-130).
* ``quadratize_cost_elqr``    — eLQR: ½-scaled Hessians but *unscaled* mixed term and
  singly-counted cross products (elqr/objects.py:56-73).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import Array

from .types import LinearDynamics, QuadraticCost


def _pad_actions(us: Array) -> tuple[Array, Array]:
    """Return (u, u_last) sequences of length T+1 for cost expansion.

    The reference pads the action trajectory with one zero column and indexes
    ``_u[..., t - 1]`` so that u_last at t=0 is the zero pad (gps/objects.py:113-116).
    """
    du = us.shape[-1]
    u_pad = jnp.concatenate([us, jnp.zeros((1, du), us.dtype)], axis=0)      # (T+1, du)
    u_last = jnp.concatenate([jnp.zeros((1, du), us.dtype), us], axis=0)     # (T+1, du)
    return u_pad, u_last


def linearize_dynamics(f: Callable, xs: Array, us: Array) -> LinearDynamics:
    """First-order expansion with residual: f(x,u) ≈ A x + B u + c.

    Vectorized equivalent of riccati/objects.py:102-108.
    ``xs``: (T, dx) reference states, ``us``: (T, du) reference actions.
    """

    def expand(x, u):
        A = jax.jacfwd(f, argnums=0)(x, u)
        B = jax.jacfwd(f, argnums=1)(x, u)
        c = f(x, u) - A @ x - B @ u
        return A, B, c

    A, B, c = jax.vmap(expand)(xs, us)
    return LinearDynamics(A=A, B=B, c=c)


def linearize_dynamics_delta(f: Callable, xs: Array, us: Array) -> tuple[Array, Array]:
    """Jacobians only (no residual) — the iLQR convention (ilqr/objects.py:114-117)."""

    def expand(x, u):
        return jax.jacfwd(f, argnums=0)(x, u), jax.jacfwd(f, argnums=1)(x, u)

    A, B = jax.vmap(expand)(xs, us)
    return A, B


def quadratize_cost_delta(
    cost: Callable, xs: Array, us: Array, weights: Array
) -> QuadraticCost:
    """Raw second-order expansion about the reference trajectory (delta coordinates).

    Vectorized equivalent of ilqr/objects.py:68-78.  ``xs``: (T+1, dx), ``us``: (T, du),
    ``weights``: (T+1,) activation.  Returns (T+1)-length stacks; c0 is zeros.
    """
    u_pad, u_last = _pad_actions(us)

    def expand(x, u, ul, a):
        Cxx = jax.hessian(cost, argnums=0)(x, u, ul, a)
        Cuu = jax.hessian(cost, argnums=1)(x, u, ul, a)
        Cxu = jax.jacfwd(jax.jacrev(cost, argnums=0), argnums=1)(x, u, ul, a)
        cx = jax.grad(cost, argnums=0)(x, u, ul, a)
        cu = jax.grad(cost, argnums=1)(x, u, ul, a)
        return Cxx, Cuu, Cxu, cx, cu

    Cxx, Cuu, Cxu, cx, cu = jax.vmap(expand)(xs, u_pad, u_last, weights)
    return QuadraticCost(
        Cxx=Cxx, cx=cx, Cuu=Cuu, cu=cu, Cxu=Cxu, c0=jnp.zeros(weights.shape, xs.dtype)
    )


def quadratize_cost_abs(
    cost: Callable, xs: Array, us: Array, weights: Array
) -> QuadraticCost:
    """Origin-recentred absolute-coordinate quadratic with ½-scaled Hessians.

    Vectorized equivalent of gps/objects.py:111-130 (and riccati/objects.py:54-65,
    which omits c0): cost(x,u) ≈ xᵀCxx x + uᵀCuu u + 2 xᵀCxu u + cxᵀx + cuᵀu + c0.
    """
    u_pad, u_last = _pad_actions(us)

    def expand(x, u, ul, a):
        H_xx = jax.hessian(cost, argnums=0)(x, u, ul, a)
        H_uu = jax.hessian(cost, argnums=1)(x, u, ul, a)
        H_xu = jax.jacfwd(jax.jacrev(cost, argnums=0), argnums=1)(x, u, ul, a)
        g_x = jax.grad(cost, argnums=0)(x, u, ul, a)
        g_u = jax.grad(cost, argnums=1)(x, u, ul, a)

        Cxx = 0.5 * H_xx
        Cuu = 0.5 * H_uu
        Cxu = 0.5 * H_xu
        cx = g_x - H_xx @ x - H_xu @ u
        cu = g_u - H_uu @ u - H_xu.T @ x
        c0 = (
            cost(x, u, ul, a)
            - x @ Cxx @ x
            - u @ Cuu @ u
            - 2.0 * x @ Cxu @ u
            - cx @ x
            - cu @ u
        )
        return Cxx, Cuu, Cxu, cx, cu, c0

    Cxx, Cuu, Cxu, cx, cu, c0 = jax.vmap(expand)(xs, u_pad, u_last, weights)
    return QuadraticCost(Cxx=Cxx, cx=cx, Cuu=Cuu, cu=cu, Cxu=Cxu, c0=c0)


def quadratize_cost_elqr(cost: Callable, x: Array, u: Array):
    """Single-point eLQR-convention quadratization (elqr/objects.py:56-73).

    cost(x,u) ≈ xᵀCxx x + uᵀCuu u + xᵀCxu u + cxᵀx + cuᵀu + c0 with Cxx = ½H_xx,
    Cuu = ½H_uu but Cxu = H_xu (unscaled) and singly-counted cross terms.
    Returns (Cxx, Cuu, Cxu, cx, cu, c0).
    """
    args = (x, u, 0.0, 1.0)
    H_xx = jax.hessian(cost, argnums=0)(*args)
    H_uu = jax.hessian(cost, argnums=1)(*args)
    H_xu = jax.jacfwd(jax.jacrev(cost, argnums=0), argnums=1)(*args)
    g_x = jax.grad(cost, argnums=0)(*args)
    g_u = jax.grad(cost, argnums=1)(*args)

    Cxx = 0.5 * H_xx
    Cuu = 0.5 * H_uu
    Cxu = H_xu
    cx = g_x - H_xx @ x - H_xu @ u
    cu = g_u - H_uu @ u - H_xu.T @ x
    c0 = cost(*args) - x @ Cxx @ x - u @ Cuu @ u - x @ Cxu @ u - cx @ x - cu @ u
    return Cxx, Cuu, Cxu, cx, cu, c0


def evaluate_quadratic_cost(cost: QuadraticCost, xs: Array, us: Array) -> Array:
    """Σ_t xᵀCxx x + uᵀCuu u + 2xᵀCxu u + cxᵀx + cuᵀu + c0 over the full horizon.

    Equivalent of ``QuadraticCost.evaluate`` (gps/objects.py:83-92); the action
    sequence is zero-padded at the terminal step.
    """
    u_pad, _ = _pad_actions(us)
    quad = (
        jnp.einsum("ti,tij,tj->t", xs, cost.Cxx, xs)
        + jnp.einsum("ti,tij,tj->t", u_pad, cost.Cuu, u_pad)
        + 2.0 * jnp.einsum("ti,tij,tj->t", xs, cost.Cxu, u_pad)
        + jnp.einsum("ti,ti->t", xs, cost.cx)
        + jnp.einsum("ti,ti->t", u_pad, cost.cu)
        + cost.c0
    )
    return jnp.sum(quad)
