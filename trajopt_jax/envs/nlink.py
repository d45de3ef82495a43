"""Planar n-link pendulum chains: DoublePendulum and QuadPendulum.

The reference implements these with hand-expanded closed-form manipulator equations
(envs/double_pendulum/double_pendulum.py:62-126 from PolicySearchToolbox;
envs/quad_pendulum/quad_pendulum.py:62-228 from Atkeson's dynamics-2d).  Here the same
physics is generated from the Lagrangian by autodiff — the idiomatic JAX construction:

* relative joint angles q, absolute link angle α_i = π + Σ_{j≤i} q_j (q = 0 is the
  upright equilibrium; the start state x0 has q1 = π, hanging down — matching the
  reference's ``th1 + np.pi`` convention);
* per-link COM at l/2, COM inertia I_i = m_i (l_i² + 1e-4)/3 and viscous joint
  friction 0.025, exactly the reference's constants (double_pendulum.py:67-72);
* mass matrix M(q) = ∂²T/∂q̇² via ``jax.hessian``, bias forces via one jvp of the
  generalized momentum — q̈ = M⁻¹(τ − fr·q̇ − ((∂p/∂q) q̇ − ∂L/∂q)).

The resulting q̈ agrees with the reference's expansions to floating-point accuracy
(they are the same Euler-Lagrange equations); tests validate against the analytic
single-pendulum ODE and energy conservation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from .base import TrajEnv, register

_INF = float("inf")


def _chain_energies(q: Array, dq: Array, masses, lengths, g: float):
    """Kinetic and potential energy of a planar chain with relative angles."""
    m = jnp.asarray(masses)
    l = jnp.asarray(lengths)
    inertias = m * (l**2 + 1e-4) / 3.0

    alpha = jnp.pi + jnp.cumsum(q)          # absolute link angles
    dalpha = jnp.cumsum(dq)

    # joint positions/velocities (joint i = base of link i)
    seg_x = l * jnp.sin(alpha)
    seg_y = -l * jnp.cos(alpha)
    joint_vx = jnp.cumsum(l * jnp.cos(alpha) * dalpha)
    joint_vy = jnp.cumsum(l * jnp.sin(alpha) * dalpha)

    # COM of link i sits half a link beyond joint i-1
    com_y = jnp.concatenate([jnp.zeros(1), jnp.cumsum(seg_y)[:-1]]) + 0.5 * seg_y
    com_vx = (
        jnp.concatenate([jnp.zeros(1), joint_vx[:-1]])
        + 0.5 * l * jnp.cos(alpha) * dalpha
    )
    com_vy = (
        jnp.concatenate([jnp.zeros(1), joint_vy[:-1]])
        + 0.5 * l * jnp.sin(alpha) * dalpha
    )

    T = 0.5 * jnp.sum(m * (com_vx**2 + com_vy**2)) + 0.5 * jnp.sum(
        inertias * dalpha**2
    )
    V = g * jnp.sum(m * com_y)
    return T, V


def nlink_ode(x: Array, u: Array, masses, lengths, friction, g: float = 9.81) -> Array:
    """q̈ from the Euler-Lagrange equations, autodiff-generated."""
    n = len(masses)
    q, dq = x[:n], x[n:]

    def lagrangian(q, dq):
        T, V = _chain_energies(q, dq, masses, lengths, g)
        return T - V

    def momentum(q, dq):
        return jax.grad(lagrangian, argnums=1)(q, dq)

    M = jax.jacfwd(momentum, argnums=1)(q, dq)                # mass matrix
    # bias = (∂p/∂q) q̇ − ∂L/∂q  (Coriolis/centrifugal + gravity)
    dp_dq_dq = jax.jvp(lambda q_: momentum(q_, dq), (q,), (dq,))[1]
    dL_dq = jax.grad(lagrangian, argnums=0)(q, dq)
    bias = dp_dq_dq - dL_dq

    tau = u - jnp.asarray(friction) * dq
    ddq = jnp.linalg.solve(M, tau - bias)
    return jnp.concatenate([dq, ddq])


def _chain_energies_parts(q, dq, masses, lengths, g: float):
    """Tile twin of :func:`_chain_energies`: the same kinetic/potential energy
    with the cumsums unrolled as running sums over components."""
    n = len(masses)
    m = tuple(float(v) for v in masses)
    l = tuple(float(v) for v in lengths)
    inertias = tuple(mi * (li**2 + 1e-4) / 3.0 for mi, li in zip(m, l))

    alpha, dalpha = [], []
    ra, rda = None, None
    for i in range(n):
        ra = q[i] if i == 0 else ra + q[i]
        rda = dq[i] if i == 0 else rda + dq[i]
        alpha.append(jnp.pi + ra)
        dalpha.append(rda)

    seg_y = [-l[i] * jnp.cos(alpha[i]) for i in range(n)]
    jvx = [None] * n
    jvy = [None] * n
    for i in range(n):
        vx = l[i] * jnp.cos(alpha[i]) * dalpha[i]
        vy = l[i] * jnp.sin(alpha[i]) * dalpha[i]
        jvx[i] = vx if i == 0 else jvx[i - 1] + vx
        jvy[i] = vy if i == 0 else jvy[i - 1] + vy

    T = 0.0
    V = 0.0
    run_y = 0.0
    for i in range(n):
        com_y = run_y + 0.5 * seg_y[i]
        run_y = run_y + seg_y[i]
        base_vx = 0.0 if i == 0 else jvx[i - 1]
        base_vy = 0.0 if i == 0 else jvy[i - 1]
        com_vx = base_vx + 0.5 * l[i] * jnp.cos(alpha[i]) * dalpha[i]
        com_vy = base_vy + 0.5 * l[i] * jnp.sin(alpha[i]) * dalpha[i]
        T = T + 0.5 * m[i] * (com_vx**2 + com_vy**2) \
            + 0.5 * inertias[i] * dalpha[i] ** 2
        V = V + g * m[i] * com_y
    return T, V


def nlink_ode_parts(x, u, masses, lengths, friction, g: float = 9.81):
    """Tile twin of :func:`nlink_ode`: the Euler-Lagrange q̈ generated from the
    same Lagrangian by forward-mode columns (``jax.jvp`` on straight-line tile
    code) with an unrolled Gauss–Jordan mass-matrix solve — eligible for the
    Pallas rollout kernel (VERDICT r3 item 5)."""
    from ..core.pscan_lqr import _gj_inv, _lmv

    n = len(masses)
    q = [x[i] for i in range(n)]
    dq = [x[n + i] for i in range(n)]
    ones = jnp.ones_like(x[0])
    zeros = jnp.zeros_like(x[0])

    def lagrangian(q_, dq_):
        T, V = _chain_energies_parts(q_, dq_, masses, lengths, g)
        return T - V

    def momentum(q_, dq_):
        cols = []
        for k in range(n):
            seed = [ones if i == k else zeros for i in range(n)]
            _, t = jax.jvp(lambda d: lagrangian(q_, d), (list(dq_),), (seed,))
            cols.append(t)
        return cols

    # mass matrix M[i][j] = ∂p_i/∂dq_j, one jvp column at a time
    M = [[None] * n for _ in range(n)]
    for j in range(n):
        seed = [ones if i == j else zeros for i in range(n)]
        _, col = jax.jvp(lambda d: momentum(q, d), (list(dq),), (seed,))
        for i in range(n):
            M[i][j] = col[i]

    _, dp_dq_dq = jax.jvp(lambda q_: momentum(q_, dq), (list(q),), (list(dq),))
    dL_dq = []
    for k in range(n):
        seed = [ones if i == k else zeros for i in range(n)]
        _, t = jax.jvp(lambda q_: lagrangian(q_, dq), (list(q),), (seed,))
        dL_dq.append(t)

    fr = tuple(float(v) for v in friction)
    rhs = [u[i] - fr[i] * dq[i] - (dp_dq_dq[i] - dL_dq[i]) for i in range(n)]
    ddq = _lmv(_gj_inv(M), rhs)
    return tuple(dq) + tuple(ddq)


@dataclass(frozen=True)
class DoublePendulum(TrajEnv):
    """Two-link chain (envs/double_pendulum/double_pendulum.py:15-175)."""

    dt: float = 0.01
    dm_state: int = 4
    dm_act: int = 2

    masses: tuple = (1.0, 1.0)
    lengths: tuple = (1.0, 1.0)
    friction: tuple = (0.025, 0.025)

    g: tuple = (0.0, 0.0, 0.0, 0.0)
    gw: tuple = (1e4, 1e4, 1e0, 1e0)
    uw: tuple = (1e-5, 1e-5)
    umax: tuple = (10.0, 10.0)
    xmax: tuple = (_INF, _INF, _INF, _INF)
    x0: tuple = (3.141592653589793, 0.0, 0.0, 0.0)

    sigma_scale: float = 1e-8
    sigma0_scale: float = 1e-4

    slew_rate: bool = False
    periodic: bool = False

    @property
    def sigma(self):
        return self.sigma_scale * jnp.eye(self.dm_state)

    @property
    def sigma0(self):
        return self.sigma0_scale * jnp.eye(self.dm_state)

    def _ode(self, x: Array, u: Array) -> Array:
        return nlink_ode(x, u, self.masses, self.lengths, self.friction)

    def _ode_parts(self, x, u) -> tuple:
        return nlink_ode_parts(x, u, self.masses, self.lengths, self.friction)


@dataclass(frozen=True)
class DoublePendulumWithCartesianCost(DoublePendulum):
    """Cartesian feature variant (double_pendulum.py:178-194)."""

    g: tuple = (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)
    gw: tuple = (1e4, 1e4, 1e4, 1e4, 1e0, 1e0)

    def features_parts(self, x) -> tuple:
        return (jnp.cos(x[0]), jnp.sin(x[0]), jnp.cos(x[1]), jnp.sin(x[1]),
                x[2], x[3])

    def features(self, x: Array) -> Array:
        return jnp.stack(
            [jnp.cos(x[0]), jnp.sin(x[0]), jnp.cos(x[1]), jnp.sin(x[1]), x[2], x[3]]
        )


@dataclass(frozen=True)
class QuadPendulum(TrajEnv):
    """Four-link chain (envs/quad_pendulum/quad_pendulum.py:15-303)."""

    dt: float = 0.01
    dm_state: int = 8
    dm_act: int = 4

    masses: tuple = (1.0, 1.0, 1.0, 1.0)
    lengths: tuple = (1.0, 1.0, 1.0, 1.0)
    friction: tuple = (0.025, 0.025, 0.025, 0.025)

    g: tuple = (0.0,) * 8
    gw: tuple = (1e4, 1e4, 1e4, 1e4, 1e0, 1e0, 1e0, 1e0)
    uw: tuple = (1e-5,) * 4
    umax: tuple = (25.0, 25.0, 25.0, 25.0)
    xmax: tuple = (_INF,) * 8
    x0: tuple = (3.141592653589793, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    sigma_scale: float = 1e-8
    sigma0_scale: float = 1e-4

    slew_rate: bool = False
    periodic: bool = False

    @property
    def sigma(self):
        return self.sigma_scale * jnp.eye(self.dm_state)

    @property
    def sigma0(self):
        return self.sigma0_scale * jnp.eye(self.dm_state)

    def _ode(self, x: Array, u: Array) -> Array:
        return nlink_ode(x, u, self.masses, self.lengths, self.friction)

    def _ode_parts(self, x, u) -> tuple:
        return nlink_ode_parts(x, u, self.masses, self.lengths, self.friction)


@dataclass(frozen=True)
class QuadPendulumWithCartesianCost(QuadPendulum):
    """Cartesian feature variant (quad_pendulum.py cartesian subclass)."""

    g: tuple = (1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    gw: tuple = (1e4,) * 8 + (1e0,) * 4

    def features_parts(self, x) -> tuple:
        return (jnp.cos(x[0]), jnp.sin(x[0]), jnp.cos(x[1]), jnp.sin(x[1]),
                jnp.cos(x[2]), jnp.sin(x[2]), jnp.cos(x[3]), jnp.sin(x[3]),
                x[4], x[5], x[6], x[7])

    def features(self, x: Array) -> Array:
        return jnp.concatenate(
            [
                jnp.stack(
                    [jnp.cos(x[0]), jnp.sin(x[0]), jnp.cos(x[1]), jnp.sin(x[1]),
                     jnp.cos(x[2]), jnp.sin(x[2]), jnp.cos(x[3]), jnp.sin(x[3])]
                ),
                x[4:],
            ]
        )


register("DoublePendulum-TO-v0", DoublePendulum)
register("DoublePendulum-TO-v1", DoublePendulumWithCartesianCost)
register("QuadPendulum-TO-v0", QuadPendulum)
register("QuadPendulum-TO-v1", QuadPendulumWithCartesianCost)
