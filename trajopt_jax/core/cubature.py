"""Distributionally-robust GPS kernels: cubature propagation through parameter
uncertainty and the adversary's MatrixNormal backward pass.

JAX replacements for the ``rgps.core`` C++ module (rgps/src/util.cpp):

* :func:`cubature_forward_pass`   — util.cpp:232-361: propagate the state marginal
  through *uncertain* linear dynamics θ = vec([A B c]) ~ MN(μθ, Σθ) using 2·d cubature
  points over the augmented (x, u, 1, noise) space; each point carries its own
  covariance Σdyn + M Σθ Mᵀ with a Cholesky embedding.  The per-point loop becomes
  one batched einsum/Cholesky over the 2·d points, the horizon a ``lax.scan``.

All Cholesky factorizations and triangular solves on the T-sequential scan paths
use :mod:`.unrolled_linalg` — statically-unrolled column/row chains instead of
XLA's while-loop LAPACK kernels, which pin each scan step at the dynamic-slice
latency floor for these ≤32-dim operands.
* :func:`policy_backward_pass`    — util.cpp:424-563: the GPS soft-KL backward pass
  plus parameter-uncertainty correction blocks P(j,k) = tr(Σθ_block · V).  The C++
  assembles P by a double loop of submatrix traces (util.cpp:494-507); here it is one
  einsum trace-contraction — no Kronecker materialization.
* :func:`parameter_augment_cost` / :func:`regularized_parameter_augment_cost`
  — util.cpp:566-624: β·/η·KL-to-reference quadratic-in-θ penalties.
* :func:`parameter_backward_pass` — util.cpp:626-798: the adversary's optimal
  MatrixNormal per timestep, W = 2(agCpp + Vpp)/(β+η), Σθ* = W⁻¹, μθ* = Σθ* w, with
  the value recursion of the *maximizing* player through the closed loop A + BK.
  (The C++ reads an uninitialized ``sigma_block`` off-diagonal (util.cpp:698, 771);
  the intended zeros are used here.)

θ-vec convention is column-major over [A B c] (rgps/objects.py:53-58), so Σθ viewed as
a 4-tensor is Σθ[a·dx+i, b·dx+j] = S4[a, i, b, j] with (a, b) column-block indices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..utils.psd import inv_psd, logdet_psd
from .unrolled_linalg import chol_solve_unrolled, chol_unrolled
from .types import (
    GaussianSequence,
    LinearGaussianPolicy,
    MatrixNormalParams,
    QuadraticCost,
    QuadraticQValue,
    QuadraticValue,
    matrices_from_vec,
    symmetrize,
)

_LOG_2PI = 1.8378770664093453


def _unpack_theta(mu_t: Array, dx: int, du: int):
    return matrices_from_vec(mu_t, dx, du)


def _theta_quadform(S4: Array, z: Array) -> Array:
    """M Σθ Mᵀ for M = kron(zᵀ, I_dx) without materializing the Kronecker:
    out[i, j] = Σ_ab z_a z_b Σθ[a·dx+i, b·dx+j]."""
    return jnp.einsum("a,aibj,b->ij", z, S4, z)


def _trace_blocks(S4: Array, V: Array) -> Array:
    """P[a, b] = tr(Σθ_block[a, b] @ V) — the correction blocks of
    rgps/src/util.cpp:494-507 as one contraction."""
    return jnp.einsum("aibj,ji->ab", S4, V)


def cubature_forward_pass(
    mu0: Array,
    sigma0: Array,
    param: MatrixNormalParams,
    sigma_dyn: Array,
    policy: LinearGaussianPolicy,
) -> tuple[GaussianSequence, GaussianSequence, GaussianSequence]:
    """Cubature propagation of the state marginal under uncertain dynamics
    (rgps/src/util.cpp:232-361).  Returns (xdist T+1, udist T, xudist T+1)."""
    dx = mu0.shape[0]
    du = policy.kff.shape[-1]
    p1 = dx + du + 1
    daug = dx + du + 1 + dx
    n_pts = 2 * daug
    jitter_u = 1e-8 * jnp.eye(du, dtype=mu0.dtype)
    jitter_xu = 1e-8 * jnp.eye(dx + du, dtype=mu0.dtype)

    def step(carry, inp):
        mu_x, sigma_x = carry
        theta_mu, theta_sigma, sig_dyn, K, kff, sig_ctl = inp

        A, B, c = _unpack_theta(theta_mu, dx, du)
        S4 = theta_sigma.reshape(p1, dx, p1, dx)

        mu_u = K @ mu_x + kff
        sigma_u = symmetrize(sig_ctl + K @ sigma_x @ K.T) + jitter_u

        cross = sigma_x @ K.T
        sigma_xu = (
            symmetrize(jnp.block([[sigma_x, cross], [cross.T, sigma_u]])) + jitter_xu
        )
        mu_xu = jnp.concatenate([mu_x, mu_u])

        # augmented sqrt-covariance: [chol(Σxu)  0  0; 0 0 0; 0 0 I]
        chol_xu = chol_unrolled(sigma_xu)
        chol_aug = jnp.zeros((daug, daug), mu_x.dtype)
        chol_aug = chol_aug.at[: dx + du, : dx + du].set(chol_xu)
        chol_aug = chol_aug.at[dx + du + 1 :, dx + du + 1 :].set(
            jnp.eye(dx, dtype=mu_x.dtype)
        )

        mu_aug = jnp.concatenate(
            [mu_xu, jnp.ones(1, mu_x.dtype), jnp.zeros(dx, mu_x.dtype)]
        )
        scale = jnp.sqrt(jnp.asarray(daug, mu_x.dtype))
        # columns of ±sqrt(d)·chol shifted by the mean → (n_pts, daug) points
        pts = mu_aug + scale * jnp.concatenate([chol_aug, -chol_aug], axis=1).T

        z_pts = pts[:, :p1]                  # (n_pts, dx+du+1) — (x, u, 1) part
        w_pts = pts[:, p1:]                  # (n_pts, dx) — unit-noise part
        covs = symmetrize(
            sig_dyn + jnp.einsum("na,aibj,nb->nij", z_pts, S4, z_pts)
        )
        chol_covs = chol_unrolled(covs)      # batched over the 2·d points
        out = (
            z_pts[:, :dx] @ A.T
            + z_pts[:, dx : dx + du] @ B.T
            + z_pts[:, dx + du : dx + du + 1] * c
            + jnp.einsum("nij,nj->ni", chol_covs, w_pts)
        )                                     # (n_pts, dx)

        mu_xn = jnp.mean(out, axis=0)
        centered = out - mu_xn
        sigma_xn = symmetrize(centered.T @ centered / n_pts)

        return (mu_xn, sigma_xn), (mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu)

    inputs = (param.mu, param.sigma, sigma_dyn, policy.K, policy.kff, policy.sigma)
    (mu_T, sigma_T), (mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu) = lax.scan(
        step, (mu0, sigma0), inputs
    )

    mu_x = jnp.concatenate([mu_x, mu_T[None]], axis=0)
    sigma_x = jnp.concatenate([sigma_x, sigma_T[None]], axis=0)

    mu_xu_T = jnp.concatenate([mu_T, jnp.zeros(du, mu_T.dtype)])
    sigma_xu_T = (
        jnp.zeros((dx + du, dx + du), sigma_T.dtype).at[:dx, :dx].set(sigma_T)
    )
    mu_xu = jnp.concatenate([mu_xu, mu_xu_T[None]], axis=0)
    sigma_xu = jnp.concatenate([sigma_xu, sigma_xu_T[None]], axis=0)

    return (
        GaussianSequence(mu=mu_x, sigma=sigma_x),
        GaussianSequence(mu=mu_u, sigma=sigma_u),
        GaussianSequence(mu=mu_xu, sigma=sigma_xu),
    )


def policy_backward_pass(
    agcost: QuadraticCost,
    param: MatrixNormalParams,
    sigma_dyn: Array,
    alpha: Array,
) -> tuple[LinearGaussianPolicy, QuadraticValue, QuadraticQValue, Array]:
    """Soft-KL backward pass under parameter uncertainty — rgps/src/util.cpp:424-563.

    Identical to the GPS pass (gps/src/util.cpp:272) plus the trace-contraction
    corrections Pxx/Puu/Pxu/px/pu/p0 entering every Q-block.
    """
    T = param.horizon
    p = param.mu.shape[-1]
    # infer dims: p = dx (dx + du + 1), with dx from sigma_dyn
    dx = sigma_dyn.shape[-1]
    p1 = p // dx
    du = p1 - dx - 1

    def step(carry, inp):
        V_next, v_next, v0_next, bad = carry
        Cxx, cx, Cuu, cu, Cxu, c0, theta_mu, theta_sigma, sig, a = inp

        A, B, c = _unpack_theta(theta_mu, dx, du)
        S4 = theta_sigma.reshape(p1, dx, p1, dx)

        P = _trace_blocks(S4, V_next)
        Pxx = P[:dx, :dx]
        Puu = P[dx : dx + du, dx : dx + du]
        Pxu = P[:dx, dx : dx + du]
        px = P[:dx, -1]
        pu = P[dx : dx + du, -1]
        p0 = P[-1, -1]

        Qxx = -(Cxx + A.T @ V_next @ A + Pxx) / a
        Quu = -(Cuu + B.T @ V_next @ B + Puu) / a
        Qux = -(Cxu + A.T @ V_next @ B + Pxu).T / a

        qu = -(cu + 2.0 * B.T @ V_next @ c + B.T @ v_next + 2.0 * pu) / a
        qx = -(cx + 2.0 * A.T @ V_next @ c + A.T @ v_next + 2.0 * px) / a
        q0 = -(c0 + v0_next + c @ V_next @ c
               + jnp.trace(V_next @ sig) + v_next @ c + p0) / a

        neg_chol = chol_unrolled(-symmetrize(Quu))
        step_bad = ~jnp.all(jnp.isfinite(neg_chol))
        safe_chol = jnp.where(
            jnp.isfinite(neg_chol), neg_chol, jnp.eye(du, dtype=neg_chol.dtype)
        )

        K = chol_solve_unrolled(safe_chol, Qux)
        kff = 0.5 * chol_solve_unrolled(safe_chol, qu)
        sigma_ctl = symmetrize(
            0.5 * chol_solve_unrolled(safe_chol, jnp.eye(du, dtype=safe_chol.dtype))
        )

        V = symmetrize(-a * (Qxx + Qux.T @ K))
        v = -a * (qx + 2.0 * Qux.T @ kff)
        logdet_m2Quu = du * jnp.log(2.0) + 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(safe_chol))
        )
        v0 = -a * (0.5 * qu @ kff + q0 + 0.5 * (du * _LOG_2PI - logdet_m2Quu))

        return (V, v, v0, bad | step_bad), (
            K, kff, sigma_ctl, V, v, v0, Qxx, Quu, Qux, qx, qu, q0
        )

    V_T, v_T, v0_T = agcost.Cxx[T], agcost.cx[T], agcost.c0[T]
    inputs = (
        agcost.Cxx[:T], agcost.cx[:T], agcost.Cuu[:T], agcost.cu[:T],
        agcost.Cxu[:T], agcost.c0[:T],
        param.mu, param.sigma, sigma_dyn, alpha,
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
    return LinearGaussianPolicy(K=K, kff=kff, sigma=sigma_ctl), value, qvalue, diverged


def parameter_augment_cost(reference: MatrixNormalParams, scale: Array):
    """Quadratic-in-θ KL penalty toward a reference MatrixNormal —
    rgps/src/util.cpp:566-594 (β·nominal) and :596-624 (η·last iterate): agCxx =
    ½·s·Λ, agcx = −s·Λμ, agc0 = ½·s·(log det 2πΣ + μᵀΛμ).  Returns (Cpp, cp, c0)."""

    def one(mu, sigma):
        lam = inv_psd(sigma)
        p = mu.shape[0]
        Cpp = 0.5 * scale * lam
        cp = -scale * lam @ mu
        c0 = 0.5 * scale * (p * _LOG_2PI + logdet_psd(sigma)) \
             + 0.5 * scale * mu @ lam @ mu
        return Cpp, cp, c0

    return jax.vmap(one)(reference.mu, reference.sigma)


def parameter_backward_pass(
    xdist: GaussianSequence,
    policy: LinearGaussianPolicy,
    sigma_dyn: Array,
    cost: QuadraticCost,
    agCpp: Array,
    agcp: Array,
    beta_plus_eta: Array,
) -> tuple[MatrixNormalParams, QuadraticValue, Array]:
    """Adversary's optimal per-timestep MatrixNormal — rgps/src/util.cpp:626-798.

    The maximizing player's value recursion runs through the closed loop A + BK; the
    optimal parameter distribution is Σθ* = W⁻¹, μθ* = Σθ* w with
    W = 2(agCpp + Vpp)/(β+η), w = −(agcp + vp)/(β+η), where
    Vpp = kron(μ_xu μ_xuᵀ + Σ_xu, V') and vp = kron(μ_xu, v').
    """
    T = policy.horizon
    dx = sigma_dyn.shape[-1]
    du = policy.kff.shape[-1]
    p1 = dx + du + 1
    p = dx * p1
    jitter = 1e-8 * jnp.eye(p1, dtype=xdist.mu.dtype)

    # state-action-offset joint over the horizon (util.cpp:661-686)
    def xu_moment(mu_x, sigma_x, K, kff, sig_ctl):
        mu_u = K @ mu_x + kff
        sigma_u = symmetrize(sig_ctl + K @ sigma_x @ K.T) \
                  + 1e-8 * jnp.eye(du, dtype=mu_x.dtype)
        cross = sigma_x @ K.T
        z_x1 = jnp.zeros((dx, 1), mu_x.dtype)
        z_u1 = jnp.zeros((du, 1), mu_x.dtype)
        sigma_xu = jnp.block(
            [[sigma_x, cross, z_x1],
             [cross.T, sigma_u, z_u1],
             [z_x1.T, z_u1.T, jnp.zeros((1, 1), mu_x.dtype)]]
        )
        sigma_xu = symmetrize(sigma_xu) + jitter
        mu_xu = jnp.concatenate([mu_x, mu_u, jnp.ones(1, mu_x.dtype)])
        return mu_xu, sigma_xu

    mu_xu, sigma_xu = jax.vmap(xu_moment)(
        xdist.mu[:T], xdist.sigma[:T], policy.K, policy.kff, policy.sigma
    )

    def step(carry, inp):
        V_next, v_next, v0_next, bad = carry
        (Cxx, cx, Cuu, cu, Cxu, c0, Cuu_next,
         aCpp, acp, mu_z, sigma_z, K, kff, sig_ctl, sig_dyn) = inp

        Vpp = jnp.kron(jnp.outer(mu_z, mu_z) + sigma_z, V_next)
        vp = jnp.kron(mu_z, v_next)

        W = symmetrize(2.0 * (aCpp + Vpp) / beta_plus_eta)
        w = -(acp + vp) / beta_plus_eta

        chol_W = chol_unrolled(W)
        step_bad = ~jnp.all(jnp.isfinite(chol_W))
        safe_chol = jnp.where(
            jnp.isfinite(chol_W), chol_W, jnp.eye(p, dtype=W.dtype)
        )

        sigma_opt = symmetrize(
            chol_solve_unrolled(safe_chol, jnp.eye(p, dtype=W.dtype))
        )
        mu_opt = sigma_opt @ w

        A, B, c = _unpack_theta(mu_opt, dx, du)
        S4 = sigma_opt.reshape(p1, dx, p1, dx)

        P = _trace_blocks(S4, V_next)
        Pxx = P[:dx, :dx]
        Puu = P[dx : dx + du, dx : dx + du]
        Pxu = P[:dx, dx : dx + du]
        px = P[:dx, -1]
        pu = P[dx : dx + du, -1]
        p0 = P[-1, -1]

        A_cl = A + B @ K
        c_cl = c + B @ kff
        # sigma_block: zeros except the control block (intended form of util.cpp:771)
        sigma_block = jnp.zeros((p1, p1), W.dtype)
        sigma_block = sigma_block.at[dx : dx + du, dx : dx + du].set(sig_ctl)
        kron_sb_V = jnp.kron(sigma_block, V_next)

        V = (-Cxx + Pxx) + K.T @ (-Cuu + Puu) @ K \
            + A_cl.T @ V_next @ A_cl + 2.0 * (-Cxu + Pxu) @ K
        V = symmetrize(V)

        v = (-cx + 2.0 * px) + 2.0 * K.T @ (-Cuu + Puu) @ kff \
            + 2.0 * (-Cxu + Pxu) @ kff + K.T @ (-cu + 2.0 * pu) \
            + 2.0 * A_cl.T @ V_next @ c_cl + A_cl.T @ v_next

        v0 = ((-c0 + p0) + kff @ (-Cuu + Puu) @ kff + kff @ (-cu + 2.0 * pu)
              - jnp.trace(Cuu_next @ sig_ctl) + v0_next
              + jnp.trace(V_next @ sig_dyn)
              + mu_opt @ kron_sb_V @ mu_opt + jnp.trace(kron_sb_V @ sigma_opt)
              + c_cl @ V_next @ c_cl + c_cl @ v_next)

        return (V, v, v0, bad | step_bad), (mu_opt, sigma_opt, V, v, v0)

    # maximizer value init: V_T = -Cxx_T (util.cpp:719-721)
    V_T, v_T, v0_T = -cost.Cxx[T], -cost.cx[T], -cost.c0[T]
    inputs = (
        cost.Cxx[:T], cost.cx[:T], cost.Cuu[:T], cost.cu[:T], cost.Cxu[:T],
        cost.c0[:T], cost.Cuu[1 : T + 1],
        agCpp, agcp, mu_xu, sigma_xu,
        policy.K, policy.kff, policy.sigma, sigma_dyn,
    )
    (_, _, _, diverged), (mu_opt, sigma_opt, V, v, v0) = lax.scan(
        step, (V_T, v_T, v0_T, jnp.asarray(False)), inputs, reverse=True
    )

    value = QuadraticValue(
        V=jnp.concatenate([V, V_T[None]], axis=0),
        v=jnp.concatenate([v, v_T[None]], axis=0),
        v0=jnp.concatenate([v0, v0_T[None]], axis=0),
    )
    return MatrixNormalParams(mu=mu_opt, sigma=sigma_opt), value, diverged
