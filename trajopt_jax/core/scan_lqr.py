"""Sequential (``lax.scan``) LQR kernels — the JAX replacements for the
reference's pybind11/Armadillo ``core`` modules.

Kernel ↔ reference map (see SURVEY.md §2.3):

* :func:`riccati_backward`      — Python Riccati loop, riccati/riccati.py:100-126
  (with the elementwise-``*`` bug at riccati.py:123 fixed to a matmul).
* :func:`ilqr_backward`         — ilqr.core.backward_pass, ilqr/src/util.cpp:83-182.
* :func:`gps_backward`          — gps.core.backward_pass (soft-KL, −1/α-scaled),
  gps/src/util.cpp:272-374.
* :func:`gaussian_forward`      — gps.core.forward_pass, gps/src/util.cpp:195-269.
* :func:`augment_cost_kl`       — gps.core.augment_cost, gps/src/util.cpp:136-193.
* :func:`policy_kl`             — gps.core.kl_divergence, gps/src/util.cpp:83-121.
* :func:`quad_expectation`      — gps.core.quad_expectation, gps/src/util.cpp:123-134.

All kernels are shape-polymorphic, dtype-polymorphic, fully jittable, and operate on
time-leading stacks (see core/types.py).  Divergence (loss of positive/negative
definiteness) is reported as a boolean plus the first failing time index, replacing the
C++ ``is_sympd`` + break (note the reference encodes "failed at t=0" as the falsy int 0,
ilqr/src/util.cpp:120-147 — a latent bug we do not replicate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..utils.psd import chol_solve, inv_psd, logdet_psd
from .types import (
    GaussianSequence,
    LinearDynamics,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    LinearPolicy,
    QuadraticCost,
    QuadraticQValue,
    QuadraticValue,
    symmetrize,
)

_LOG_2PI = 1.8378770664093453  # log(2π)


# --------------------------------------------------------------------------------------
# Riccati (exact LQR, absolute-coordinate convention)
# --------------------------------------------------------------------------------------

def riccati_backward(
    cost: QuadraticCost, dyn: LinearDynamics
) -> tuple[LinearPolicy, QuadraticValue]:
    """Exact finite-horizon LQR backward pass in the absolute-coordinate convention.

    Equivalent of riccati/riccati.py:100-126.  kff = −½ Quu⁻¹ qu because Hessians are
    ½-scaled; V-recursion uses the (corrected) matrix product Qxx + Qux ᵀ K.
    """

    def step(carry, inp):
        V_next, v_next = carry
        Cxx, cx, Cuu, cu, Cxu, A, B, c = inp

        Qxx = Cxx + A.T @ V_next @ A
        Quu = Cuu + B.T @ V_next @ B
        Qux = Cxu.T + B.T @ V_next @ A

        qx = cx + 2.0 * A.T @ V_next @ c + A.T @ v_next
        qu = cu + 2.0 * B.T @ V_next @ c + B.T @ v_next

        chol = jnp.linalg.cholesky(symmetrize(Quu))
        K = -chol_solve(chol, Qux)
        kff = -0.5 * chol_solve(chol, qu)

        V = Qxx + Qux.T @ K
        v = qx + 2.0 * (Qux.T @ kff)
        return (V, v), (K, kff, V, v)

    T = dyn.horizon
    V_T, v_T = cost.Cxx[T], cost.cx[T]
    inputs = (
        cost.Cxx[:T], cost.cx[:T], cost.Cuu[:T], cost.cu[:T], cost.Cxu[:T],
        dyn.A, dyn.B, dyn.c,
    )
    (_, _), (K, kff, V, v) = lax.scan(step, (V_T, v_T), inputs, reverse=True)

    V_full = jnp.concatenate([V, V_T[None]], axis=0)
    v_full = jnp.concatenate([v, v_T[None]], axis=0)
    v0_full = jnp.zeros(V_full.shape[0], V_full.dtype)
    return LinearPolicy(K=K, kff=kff), QuadraticValue(V=V_full, v=v_full, v0=v0_full)


# --------------------------------------------------------------------------------------
# iLQR (regularized, delta-coordinate convention)
# --------------------------------------------------------------------------------------

def ilqr_backward(
    cost: QuadraticCost,
    A: Array,
    B: Array,
    lmbda: Array,
    reg: int,
) -> tuple[LinearPolicy, QuadraticValue, QuadraticQValue, Array, Array]:
    """Regularized iLQR backward pass — ilqr/src/util.cpp:83-182.

    ``reg == 1`` adds λI to Quu; ``reg == 2`` adds λI to the value Hessian before
    forming the regularized Q-blocks.  Returns (policy, value, qvalue, dV, diverged)
    where dV = Σ_t [kffᵀqu, ½ kffᵀ Quu kff] is the expected-improvement pair used by the
    line search (ilqr/ilqr.py:198) and ``diverged`` is a boolean scalar.
    """
    dx, du = A.shape[-1], B.shape[-1]
    eye_x = jnp.eye(dx, dtype=A.dtype)
    eye_u = jnp.eye(du, dtype=A.dtype)

    def step(carry, inp):
        V_next, v_next, dV, bad = carry
        Cxx, cx, Cuu, cu, Cxu, A_t, B_t = inp

        Qxx = Cxx + A_t.T @ V_next @ A_t
        Quu = Cuu + B_t.T @ V_next @ B_t
        Qux = (Cxu + A_t.T @ V_next @ B_t).T

        qu = cu + B_t.T @ v_next
        qx = cx + A_t.T @ v_next

        V_reg = V_next + (lmbda * eye_x if reg == 2 else 0.0 * eye_x)
        Qux_reg = (Cxu + A_t.T @ V_reg @ B_t).T
        Quu_reg = Cuu + B_t.T @ V_reg @ B_t + (lmbda * eye_u if reg == 1 else 0.0 * eye_u)

        chol = jnp.linalg.cholesky(symmetrize(Quu_reg))
        step_bad = ~jnp.all(jnp.isfinite(chol))
        # guard the solve so a failed factorization poisons only `bad`, not the carry
        safe_chol = jnp.where(jnp.isfinite(chol), chol, eye_u)

        K = -chol_solve(safe_chol, Qux_reg)
        kff = -chol_solve(safe_chol, qu)

        dV = dV + jnp.stack([kff @ qu, 0.5 * kff @ Quu @ kff])

        v = qx + K.T @ Quu @ kff + K.T @ qu + Qux.T @ kff
        V = symmetrize(Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K)

        return (V, v, dV, bad | step_bad), (K, kff, V, v, Qxx, Quu, Qux, qx, qu)

    T = A.shape[0]
    V_T, v_T = cost.Cxx[T], cost.cx[T]
    dV0 = jnp.zeros(2, A.dtype)
    inputs = (cost.Cxx[:T], cost.cx[:T], cost.Cuu[:T], cost.cu[:T], cost.Cxu[:T], A, B)
    (_, _, dV, diverged), (K, kff, V, v, Qxx, Quu, Qux, qx, qu) = lax.scan(
        step, (V_T, v_T, dV0, jnp.asarray(False)), inputs, reverse=True
    )

    V_full = jnp.concatenate([V, V_T[None]], axis=0)
    v_full = jnp.concatenate([v, v_T[None]], axis=0)
    value = QuadraticValue(V=V_full, v=v_full, v0=jnp.zeros(T + 1, A.dtype))
    qvalue = QuadraticQValue(
        Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, q0=jnp.zeros(T, A.dtype)
    )
    return LinearPolicy(K=K, kff=kff), value, qvalue, dV, diverged


# --------------------------------------------------------------------------------------
# GPS (soft-KL / maximum-entropy backward pass, absolute convention)
# --------------------------------------------------------------------------------------

def gps_backward(
    agcost: QuadraticCost,
    dyn: LinearGaussianDynamics,
    alpha: Array,
) -> tuple[LinearGaussianPolicy, QuadraticValue, QuadraticQValue, Array]:
    """Soft-KL Riccati pass producing a stochastic controller — gps/src/util.cpp:272-374.

    All Q-blocks are scaled by −1/α(t); Quu must therefore be **negative** definite for
    a valid Gaussian policy (the C++ treats ``Quu.is_sympd() == true`` as divergence,
    util.cpp:329; we use the stronger/intended check that −Quu is PD).  The controller
    is K = −Quu⁻¹Qux, kff = −½Quu⁻¹qu, Σ_ctl = −½Quu⁻¹.
    """
    T = dyn.horizon
    du = dyn.B.shape[-1]

    def step(carry, inp):
        V_next, v_next, v0_next, bad = carry
        Cxx, cx, Cuu, cu, Cxu, c0, A, B, c, sig, a = inp

        Qxx = -(Cxx + A.T @ V_next @ A) / a
        Quu = -(Cuu + B.T @ V_next @ B) / a
        Qux = -(Cxu + A.T @ V_next @ B).T / a

        qu = -(cu + 2.0 * B.T @ V_next @ c + B.T @ v_next) / a
        qx = -(cx + 2.0 * A.T @ V_next @ c + A.T @ v_next) / a
        q0 = -(c0 + v0_next + c @ V_next @ c
               + jnp.trace(V_next @ sig) + v_next @ c) / a

        neg_chol = jnp.linalg.cholesky(-symmetrize(Quu))
        step_bad = ~jnp.all(jnp.isfinite(neg_chol))
        safe_chol = jnp.where(jnp.isfinite(neg_chol), neg_chol, jnp.eye(du, dtype=neg_chol.dtype))

        # Quu is negative definite: Quu⁻¹ = −(−Quu)⁻¹, factorized once
        K = chol_solve(safe_chol, Qux)
        kff = 0.5 * chol_solve(safe_chol, qu)
        sigma_ctl = symmetrize(0.5 * chol_solve(safe_chol, jnp.eye(du, dtype=safe_chol.dtype)))

        V = symmetrize(-a * (Qxx + Qux.T @ K))
        v = -a * (qx + 2.0 * Qux.T @ kff)
        # log det(−2 Quu) via the Cholesky of −Quu: det(−2Quu) = 2^du det(−Quu)
        logdet_m2Quu = du * jnp.log(2.0) + 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(neg_chol))
        )
        v0 = -a * (0.5 * qu @ kff + q0 + 0.5 * (du * _LOG_2PI - logdet_m2Quu))

        return (V, v, v0, bad | step_bad), (
            K, kff, sigma_ctl, V, v, v0, Qxx, Quu, Qux, qx, qu, q0
        )

    V_T, v_T, v0_T = agcost.Cxx[T], agcost.cx[T], agcost.c0[T]
    inputs = (
        agcost.Cxx[:T], agcost.cx[:T], agcost.Cuu[:T], agcost.cu[:T],
        agcost.Cxu[:T], agcost.c0[:T],
        dyn.A, dyn.B, dyn.c, dyn.sigma, alpha,
    )
    (_, _, _, diverged), outs = lax.scan(
        step, (V_T, v_T, v0_T, jnp.asarray(False)), inputs, reverse=True
    )
    K, kff, sigma_ctl, V, v, v0, Qxx, Quu, Qux, qx, qu, q0 = outs

    value = QuadraticValue(
        V=jnp.concatenate([V, V_T[None]], axis=0),
        v=jnp.concatenate([v, v_T[None]], axis=0),
        v0=jnp.concatenate([v0, v0_T[None]], axis=0),
    )
    qvalue = QuadraticQValue(Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, q0=q0)
    policy = LinearGaussianPolicy(K=K, kff=kff, sigma=sigma_ctl)
    return policy, value, qvalue, diverged


def gaussian_forward(
    dyn: LinearGaussianDynamics,
    policy: LinearGaussianPolicy,
    mu0: Array,
    sigma0: Array,
) -> tuple[GaussianSequence, GaussianSequence, GaussianSequence]:
    """Exact propagation of the (x, u, xu) joint through linear-Gaussian dynamics and
    controller — gps/src/util.cpp:195-269.

    Returns (xdist: T+1, udist: T, xudist: T+1); the terminal xu entry carries the
    terminal state marginal with a zero action block, matching util.cpp:253-256.
    """
    dx = dyn.A.shape[-1]
    du = dyn.B.shape[-1]

    def step(carry, inp):
        mu_x, sigma_x = carry
        A, B, c, sig_dyn, K, kff, sig_ctl = inp

        mu_u = K @ mu_x + kff
        sigma_u = symmetrize(sig_ctl + K @ sigma_x @ K.T)

        cross = sigma_x @ K.T
        sigma_xu = symmetrize(
            jnp.block([[sigma_x, cross], [cross.T, sigma_u]])
        )
        mu_xu = jnp.concatenate([mu_x, mu_u])

        AB = jnp.concatenate([A, B], axis=1)
        sigma_xn = symmetrize(sig_dyn + AB @ sigma_xu @ AB.T)
        mu_xn = AB @ mu_xu + c

        return (mu_xn, sigma_xn), (mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu)

    inputs = (dyn.A, dyn.B, dyn.c, dyn.sigma, policy.K, policy.kff, policy.sigma)
    (mu_T, sigma_T), (mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu) = lax.scan(
        step, (mu0, sigma0), inputs
    )

    mu_x = jnp.concatenate([mu_x, mu_T[None]], axis=0)
    sigma_x = jnp.concatenate([sigma_x, sigma_T[None]], axis=0)

    mu_xu_T = jnp.concatenate([mu_T, jnp.zeros(du, mu_T.dtype)])
    sigma_xu_T = jnp.zeros((dx + du, dx + du), sigma_T.dtype).at[:dx, :dx].set(sigma_T)
    mu_xu = jnp.concatenate([mu_xu, mu_xu_T[None]], axis=0)
    sigma_xu = jnp.concatenate([sigma_xu, sigma_xu_T[None]], axis=0)

    return (
        GaussianSequence(mu=mu_x, sigma=sigma_x),
        GaussianSequence(mu=mu_u, sigma=sigma_u),
        GaussianSequence(mu=mu_xu, sigma=sigma_xu),
    )


def augment_cost_kl(
    cost: QuadraticCost, policy: LinearGaussianPolicy, alpha: Array
) -> QuadraticCost:
    """Fold the α-weighted KL(π‖π_old) penalty into the quadratic cost —
    gps/src/util.cpp:136-193.  The terminal (T+1)-th slice passes through unchanged.
    """

    def augment(Cxx, cx, Cuu, cu, Cxu, c0, K, kff, sig, a):
        lam = inv_psd(sig)
        agCxx = Cxx + 0.5 * a * K.T @ lam @ K
        agCuu = Cuu + 0.5 * a * lam
        agCxu = Cxu - 0.5 * a * K.T @ lam
        agcx = cx + a * K.T @ lam @ kff
        agcu = cu - a * lam @ kff
        du = sig.shape[-1]
        agc0 = c0 + 0.5 * a * (du * _LOG_2PI + logdet_psd(sig)) \
                  + 0.5 * a * kff @ lam @ kff
        return agCxx, agcx, agCuu, agcu, agCxu, agc0

    T = policy.horizon
    agCxx, agcx, agCuu, agcu, agCxu, agc0 = jax.vmap(augment)(
        cost.Cxx[:T], cost.cx[:T], cost.Cuu[:T], cost.cu[:T], cost.Cxu[:T],
        cost.c0[:T], policy.K, policy.kff, policy.sigma, alpha,
    )
    return QuadraticCost(
        Cxx=jnp.concatenate([agCxx, cost.Cxx[T:]], axis=0),
        cx=jnp.concatenate([agcx, cost.cx[T:]], axis=0),
        Cuu=jnp.concatenate([agCuu, cost.Cuu[T:]], axis=0),
        cu=jnp.concatenate([agcu, cost.cu[T:]], axis=0),
        Cxu=jnp.concatenate([agCxu, cost.Cxu[T:]], axis=0),
        c0=jnp.concatenate([agc0, cost.c0[T:]], axis=0),
    )


def policy_kl(
    p: LinearGaussianPolicy, q: LinearGaussianPolicy, xdist: GaussianSequence
) -> Array:
    """Per-timestep KL(p‖q) between linear-Gaussian policies under the state marginal —
    gps/src/util.cpp:83-121 (identical math reused at rgps/src/util.cpp:85-123).
    Returns a (T,) vector.
    """

    def kl_t(pK, pk, psig, qK, qk, qsig, mu, sig):
        du = pk.shape[0]
        q_lam = inv_psd(qsig)
        dK = qK - pK
        dk = pk - qk
        diff_K = dK.T @ q_lam @ dK
        diff_crs = dK.T @ q_lam @ dk
        diff_kff = dk @ q_lam @ dk
        return (
            0.5 * (logdet_psd(qsig) - logdet_psd(psig))
            + 0.5 * jnp.trace(q_lam @ psig)
            - 0.5 * du
            + 0.5 * jnp.trace(diff_K @ sig)
            + 0.5 * mu @ diff_K @ mu
            - mu @ diff_crs
            + 0.5 * diff_kff
        )

    T = p.horizon
    return jax.vmap(kl_t)(
        p.K, p.kff, p.sigma, q.K, q.kff, q.sigma, xdist.mu[:T], xdist.sigma[:T]
    )


def quad_expectation(
    mu: Array, sigma: Array, V: Array, v: Array, v0: Array
) -> Array:
    """E[xᵀVx + vᵀx + v0] under N(mu, sigma) — gps/src/util.cpp:123-134."""
    return mu @ V @ mu + mu @ v + v0 + jnp.trace(V @ sigma)


def gaussian_kl(p: GaussianSequence, q: GaussianSequence) -> Array:
    """Per-step KL(p‖q) between Gaussian sequences — rgps/src/util.cpp:125-152."""

    def kl_t(mu_p, sig_p, mu_q, sig_q):
        d = mu_p.shape[0]
        lam_q = inv_psd(sig_q)
        diff = mu_q - mu_p
        return 0.5 * (
            jnp.trace(lam_q @ sig_p)
            + diff @ lam_q @ diff
            + logdet_psd(sig_q)
            - logdet_psd(sig_p)
            - d
        )

    return jax.vmap(kl_t)(p.mu, p.sigma, q.mu, q.sigma)


def gaussian_interp_kl(
    q: GaussianSequence, p: GaussianSequence, a: float
) -> GaussianSequence:
    """Precision-weighted (KL-geodesic) interpolation between Gaussian sequences —
    rgps/src/util.cpp:188-215: Σ = (aΛ_p + (1−a)Λ_q)⁻¹, μ = Σ(aΛ_pμ_p + (1−a)Λ_qμ_q)."""

    def interp_t(mu_q, sig_q, mu_p, sig_p):
        lam_q = inv_psd(sig_q)
        lam_p = inv_psd(sig_p)
        sig = inv_psd(a * lam_p + (1.0 - a) * lam_q)
        mu = sig @ (a * lam_p @ mu_p + (1.0 - a) * lam_q @ mu_q)
        return mu, sig

    mu, sigma = jax.vmap(interp_t)(q.mu, q.sigma, p.mu, p.sigma)
    return GaussianSequence(mu=mu, sigma=sigma)


def gaussian_interp_w2(
    q: GaussianSequence, p: GaussianSequence, a: float
) -> GaussianSequence:
    """Wasserstein-2 geodesic interpolation — rgps/src/util.cpp:155-185.

    Uses the symmetric matrix square root computed from the eigendecomposition
    (Armadillo's ``sqrtmat`` on SPD inputs).
    """

    def sqrtm(M):
        w, U = jnp.linalg.eigh(symmetrize(M))
        w = jnp.maximum(w, 0.0)
        return (U * jnp.sqrt(w)) @ U.T

    def interp_t(mu_q, sig_q, mu_p, sig_p):
        mu = (1.0 - a) * mu_q + a * mu_p
        s_q = sqrtm(sig_q)
        s_q_inv = inv_psd(s_q)
        mid = (1.0 - a) * sig_q + a * sqrtm(s_q @ sig_p @ s_q)
        sig = s_q_inv @ mid @ mid @ s_q_inv
        return mu, sig

    mu, sigma = jax.vmap(interp_t)(q.mu, q.sigma, p.mu, p.sigma)
    return GaussianSequence(mu=mu, sigma=sigma)
