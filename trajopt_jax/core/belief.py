"""Belief-space LQR kernels (BSP-iLQR, van den Berg et al.).

JAX replacements for ``bspilqr.core.backward_pass`` (bspilqr/src/util.cpp:83-204)
and ``AnalyticalLinearBeliefDynamics.taylor_expansion`` (bspilqr/objects.py:235-256).

The belief value function is quadratic in the belief mean with an extra linear channel
``tau`` against vec(Σ): V(b) = ½ μᵀSμ + sᵀμ + τᵀvec(Σ).  The belief dynamics map
(μ, Σ, u) ↦ (f, W, Φ) (one EKF predict+gain step) is differentiated as a whole —
here with one vmapped ``jacfwd`` over the horizon instead of T autograd calls on a
hand-flattened closure.

NOTE on vec order: the reference mixes autograd's C-order flatten with Armadillo's
F-order ``vectorise``; both operate on *symmetric* matrices (Σ, S, W, Φ), for which the
two vectorizations coincide elementwise, so one C-order convention is used throughout.

NOTE on a reference defect: bspilqr/src/util.cpp:158 contracts ``U`` against
``tau.col(i)`` — uninitialized Armadillo memory at that point in the backward loop.
The van den Berg recursion calls for the *next* step's tau; we use ``tau_{t+1}``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..core.ekf import belief_ekf_step
from ..core.types import LinearPolicy, symmetrize


class BeliefDynamicsExpansion(NamedTuple):
    """First-order expansion blocks of the belief-dynamics map, stacked over T.

    Rows of the full Jacobian of (f, vec(W), vec(Φ)) wrt (μ, vec(Σ), u), sliced as in
    bspilqr/objects.py:247-256: F,G from f; X,Y,Z from W; T,U,V from Φ.
    """

    F: Array  # (T, b, b)      df/dmu
    G: Array  # (T, b, a)      df/du
    X: Array  # (T, b*b, b)    dW/dmu
    Y: Array  # (T, b*b, b*b)  dW/dvec(Sigma)
    Z: Array  # (T, b*b, a)    dW/du
    T: Array  # (T, b*b, b)    dPhi/dmu
    U: Array  # (T, b*b, b*b)  dPhi/dvec(Sigma)
    V: Array  # (T, b*b, a)    dPhi/du


class BeliefCostExpansion(NamedTuple):
    """Raw (delta-coordinate) quadratic expansion of the belief cost
    (bspilqr/objects.py:111-144)."""

    Q: Array  # (T+1, b, b)   hessian wrt mu
    q: Array  # (T+1, b)      grad wrt mu
    R: Array  # (T+1, a, a)   hessian wrt u
    r: Array  # (T+1, a)      grad wrt u
    P: Array  # (T+1, b, a)   mixed mu/u
    p: Array  # (T+1, b*b)    grad wrt vec(Sigma)


def belief_dynamics_expansion(env, mu_b: Array, sigma_b: Array, us: Array):
    """Jacobian of the flattened EKF belief-update map along a belief trajectory.

    mu_b: (T, b), sigma_b: (T, b, b), us: (T, a).
    """
    b = mu_b.shape[-1]
    a = us.shape[-1]

    def flat_dyn(z):
        mu = z[:b]
        sig = z[b : b + b * b].reshape(b, b)
        u = z[b + b * b :]
        f, W, phi = belief_ekf_step(env, mu, sig, u)
        return jnp.concatenate([f, W.reshape(-1), phi.reshape(-1)])

    def expand(mu, sig, u):
        z = jnp.concatenate([mu, sig.reshape(-1), u])
        J = jax.jacfwd(flat_dyn)(z)
        F = J[:b, :b]
        G = J[:b, -a:]
        X = J[b : b + b * b, :b]
        Y = J[b : b + b * b, b : b + b * b]
        Z = J[b : b + b * b, -a:]
        T_ = J[b + b * b :, :b]
        U = J[b + b * b :, b : b + b * b]
        V = J[b + b * b :, -a:]
        return F, G, X, Y, Z, T_, U, V

    F, G, X, Y, Z, T_, U, V = jax.vmap(expand)(mu_b, sigma_b, us)
    return BeliefDynamicsExpansion(F=F, G=G, X=X, Y=Y, Z=Z, T=T_, U=U, V=V)


def belief_cost_expansion(env, mu_b: Array, sigma_b: Array, us: Array):
    """Raw second-order expansion of cost(μ, Σ, u) along the belief trajectory
    (T+1 slices; terminal action zero-padded) — bspilqr/objects.py:129-144."""
    a = us.shape[-1]
    u_pad = jnp.concatenate([us, jnp.zeros((1, a), us.dtype)], axis=0)

    cost = env.cost

    def expand(mu, sig, u):
        Q = jax.hessian(cost, argnums=0)(mu, sig, u)
        q = jax.grad(cost, argnums=0)(mu, sig, u)
        R = jax.hessian(cost, argnums=2)(mu, sig, u)
        r = jax.grad(cost, argnums=2)(mu, sig, u)
        P = jax.jacfwd(jax.jacrev(cost, argnums=0), argnums=2)(mu, sig, u)
        p = jax.grad(cost, argnums=1)(mu, sig, u).reshape(-1)
        return Q, q, R, r, P, p

    Q, q, R, r, P, p = jax.vmap(expand)(mu_b, sigma_b, u_pad)
    return BeliefCostExpansion(Q=Q, q=q, R=R, r=r, P=P, p=p)


def bsp_backward(
    cost: BeliefCostExpansion,
    dyn: BeliefDynamicsExpansion,
    lmbda: Array,
    reg: int,
):
    """Belief-value backward recursion with the vec(Σ) channel —
    bspilqr/src/util.cpp:83-204 (with the tau-index fix, see module docstring).

    Returns (policy, S (T+1,b,b), s (T+1,b), tau (T+1,b²), dS (2,), diverged).
    """
    b = dyn.F.shape[-1]
    a = dyn.G.shape[-1]
    eye_b = jnp.eye(b, dtype=dyn.F.dtype)
    eye_a = jnp.eye(a, dtype=dyn.F.dtype)

    def step(carry, inp):
        S_n, s_n, tau_n, dS, bad = carry
        Q, q, R, r, P, p, F, G, X, Y, Z, T_, U, V = inp

        C = Q + F.T @ S_n @ F
        D = R + G.T @ S_n @ G
        E = (P + F.T @ S_n @ G).T

        vecS = S_n.reshape(-1)
        c = q + F.T @ s_n + T_.T @ tau_n + 0.5 * X.T @ vecS
        d = r + G.T @ s_n + V.T @ tau_n + 0.5 * Z.T @ vecS
        e = p + U.T @ tau_n + 0.5 * Y.T @ vecS

        S_reg = S_n + (lmbda * eye_b if reg == 2 else 0.0 * eye_b)
        E_reg = (P + F.T @ S_reg @ G).T
        D_reg = R + G.T @ S_reg @ G + (lmbda * eye_a if reg == 1 else 0.0 * eye_a)

        chol = jnp.linalg.cholesky(symmetrize(D_reg))
        step_bad = ~jnp.all(jnp.isfinite(chol))
        safe_chol = jnp.where(jnp.isfinite(chol), chol, eye_a)

        from ..utils.psd import chol_solve

        K = -chol_solve(safe_chol, E_reg)
        kff = -chol_solve(safe_chol, d)

        dS = dS + jnp.stack([kff @ d, 0.5 * kff @ D @ kff])

        tau = e
        s = c + K.T @ D @ kff + K.T @ d + E.T @ kff
        S = symmetrize(C + K.T @ D @ K + K.T @ E + E.T @ K)

        return (S, s, tau, dS, bad | step_bad), (K, kff, S, s, tau)

    Tn = dyn.F.shape[0]
    S_T, s_T, tau_T = cost.Q[Tn], cost.q[Tn], cost.p[Tn]
    dS0 = jnp.zeros(2, dyn.F.dtype)
    inputs = (
        cost.Q[:Tn], cost.q[:Tn], cost.R[:Tn], cost.r[:Tn], cost.P[:Tn], cost.p[:Tn],
        dyn.F, dyn.G, dyn.X, dyn.Y, dyn.Z, dyn.T, dyn.U, dyn.V,
    )
    (_, _, _, dS, diverged), (K, kff, S, s, tau) = lax.scan(
        step, (S_T, s_T, tau_T, dS0, jnp.asarray(False)), inputs, reverse=True
    )

    S_full = jnp.concatenate([S, S_T[None]], axis=0)
    s_full = jnp.concatenate([s, s_T[None]], axis=0)
    tau_full = jnp.concatenate([tau, tau_T[None]], axis=0)
    return LinearPolicy(K=K, kff=kff), S_full, s_full, tau_full, dS, diverged


def bsp_backward_sqrt(
    cost: BeliefCostExpansion,
    dyn: BeliefDynamicsExpansion,
    lmbda: Array,
    reg: int,
):
    """Square-root belief-value backward recursion (same contract as
    :func:`bsp_backward`).

    Carries the value Hessian's upper-triangular factor ``U`` (S = UᵀU) through
    stacked-QR array updates instead of the dense S of bspilqr/src/util.cpp:146-189,
    making the μ-channel value PSD **by construction** — the companion of
    :mod:`core.sqrt_ekf` for the solver side, so the ``belief_filter='sqrt'`` MPC
    path is square-root end-to-end in f32.

    The recursion identity used: with closed-loop ``A_cl = F + G K``,

        S = A_clᵀ S' A_cl + [I K]ᵀ H [I; K],   H = [[Q, P], [Pᵀ, R]],

    so ``U`` updates as the QR R-factor of ``[U' A_cl ; L_Hᵀ [I; K]]``.  The stage
    Hessian ``H`` must be PSD — true for the reference's belief costs (quadratic
    μ-goal + tr(WΣ) + uᵀRu, lightdark.py:76-79) — and receives the same f32-only
    relative jitter as the dense EKF before factoring.  The regularized gain solve
    factors ``D_reg`` as a QR of ``[U_reg G ; chol(R + λ·1[reg=1] I)ᵀ]`` and never
    forms GᵀSG.  The linear channels (s, τ) have no definiteness to protect and
    keep the dense recursion (contractions against vec(S) = vec(UᵀU) are single
    products, not squarings of the carried state).
    """
    import jax.scipy.linalg as jsl

    from .sqrt_ekf import _sign_fix

    b = dyn.F.shape[-1]
    a = dyn.G.shape[-1]
    dt = dyn.F.dtype
    eye_b = jnp.eye(b, dtype=dt)
    eye_a = jnp.eye(a, dtype=dt)

    def qr_r(pre):
        return _sign_fix(jnp.linalg.qr(pre, mode="r"))

    def safe_chol(M):
        M = symmetrize(M)
        if dt == jnp.float32:
            d = M.shape[-1]
            scale = jnp.trace(M) / d + jnp.asarray(1e-12, dt)
            M = M + 1e-5 * scale * jnp.eye(d, dtype=dt)
        L = jnp.linalg.cholesky(M)
        bad = ~jnp.all(jnp.isfinite(L))
        return jnp.where(jnp.isfinite(L), L, jnp.eye(M.shape[-1], dtype=dt)), bad

    sqrt_lam = jnp.sqrt(jnp.asarray(lmbda, dt))

    def step(carry, inp):
        U_n, s_n, tau_n, dS, bad = carry
        Q, q, R, r, P, p, F, G, X, Y, Z, T_, Uj, V = inp

        UF = U_n @ F
        UG = U_n @ G
        S_n = U_n.T @ U_n
        vecS = S_n.reshape(-1)

        D = R + UG.T @ UG
        E = P.T + UG.T @ UF

        c = q + F.T @ s_n + T_.T @ tau_n + 0.5 * X.T @ vecS
        d = r + G.T @ s_n + V.T @ tau_n + 0.5 * Z.T @ vecS
        e = p + Uj.T @ tau_n + 0.5 * Y.T @ vecS

        if reg == 2:
            U_reg = qr_r(jnp.concatenate([U_n, sqrt_lam * eye_b], axis=0))
            E_reg = P.T + (U_reg @ G).T @ (U_reg @ F)
            L_r, bad_r = safe_chol(R)
            pre_d = jnp.concatenate([U_reg @ G, L_r.T], axis=0)
        else:
            E_reg = E
            L_r, bad_r = safe_chol(R + lmbda * eye_a)
            pre_d = jnp.concatenate([UG, L_r.T], axis=0)

        Ud = qr_r(pre_d)
        diag_ok = jnp.all(jnp.abs(jnp.diagonal(Ud)) > 1e-30) & jnp.all(
            jnp.isfinite(Ud)
        )
        step_bad = bad_r | ~diag_ok
        Ud_safe = jnp.where(diag_ok, Ud, eye_a)

        def solve_d(rhs):
            y = jsl.solve_triangular(Ud_safe, rhs, trans=1, lower=False)
            return jsl.solve_triangular(Ud_safe, y, lower=False)

        K = -solve_d(E_reg)
        kff = -solve_d(d)

        dS = dS + jnp.stack([kff @ d, 0.5 * kff @ D @ kff])

        tau = e
        s = c + K.T @ (D @ kff) + K.T @ d + E.T @ kff

        Acl = F + G @ K
        H = jnp.block([[Q, P], [P.T, R]])
        L_h, bad_h = safe_chol(H)
        M2 = L_h.T @ jnp.concatenate([eye_b, K], axis=0)
        U_new = qr_r(jnp.concatenate([U_n @ Acl, M2], axis=0))

        return (U_new, s, tau, dS, bad | step_bad | bad_h), (K, kff, U_new, s, tau)

    Tn = dyn.F.shape[0]
    U_T, bad_T = safe_chol(cost.Q[Tn])
    U_T = U_T.T  # upper factor
    s_T, tau_T = cost.q[Tn], cost.p[Tn]
    dS0 = jnp.zeros(2, dt)
    inputs = (
        cost.Q[:Tn], cost.q[:Tn], cost.R[:Tn], cost.r[:Tn], cost.P[:Tn], cost.p[:Tn],
        dyn.F, dyn.G, dyn.X, dyn.Y, dyn.Z, dyn.T, dyn.U, dyn.V,
    )
    (_, _, _, dS, diverged), (K, kff, U, s, tau) = lax.scan(
        step, (U_T, s_T, tau_T, dS0, bad_T), inputs, reverse=True
    )

    S = jnp.einsum("tij,tik->tjk", U, U)
    S_full = jnp.concatenate([S, (U_T.T @ U_T)[None]], axis=0)
    s_full = jnp.concatenate([s, s_T[None]], axis=0)
    tau_full = jnp.concatenate([tau, tau_T[None]], axis=0)
    return LinearPolicy(K=K, kff=kff), S_full, s_full, tau_full, dS, diverged
