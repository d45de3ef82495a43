"""Square-root (Cholesky-factor) extended Kalman filtering.

The dense EKF (:mod:`trajopt_jax.core.ekf`) mirrors the reference's
``bspilqr/objects.py:24-73`` and keeps it PSD-safe in f32 with the Joseph form plus
relative jitters.  This module is the *principled* f32 answer: propagate the lower
Cholesky factor ``L`` of the belief covariance (Σ = L Lᵀ) through QR-based array
updates, so the covariance is PSD **by construction** — no jitter, no Joseph form,
and roughly half the condition number in the working arrays (the factor lives in
"amplitude" space, so the reference's 1e-8 observation-noise floors
(envs/car.py:86-89) become a representable 1e-4 instead of underflowing against O(1)
entries in f32).

Array algorithm (Kaminski/Bierman; see e.g. Kailath, *Linear Estimation* ch. 12):

* predict — QR of the stacked pre-array ``[[LᵀAᵀ], [L_qᵀ]]`` gives the predicted
  factor as the transposed triangular post-array;
* update — QR of the pre-array ``[[L_rᵀ, 0], [LᵀHᵀ, Lᵀ]]`` yields in one shot the
  innovation-covariance factor, the (transformed) Kalman gain, and the posterior
  factor, since the post-array ``[[X, Y], [0, Z]]`` satisfies ``XᵀX = S``,
  ``XᵀY = HΣ``, ``YᵀY + ZᵀZ = Σ`` ⇒ ``K = Yᵀ X⁻ᵀ`` and ``Σ⁺ = Zᵀ Z``.

Both use only QR and triangular solves, which are differentiable in JAX (including
``jacfwd`` — the failure mode CLAUDE.md flags for eigh-clamping does not apply).
The post-arrays are sign-normalized (non-negative diagonal) so factors are unique
and batch-comparable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax import Array


def _sign_fix(R: Array) -> Array:
    """Flip row signs of an upper-triangular post-array so diag(R) >= 0.

    QR is unique only up to a ±1 diagonal left factor; the products L Lᵀ and the
    gain K are invariant, but normalizing makes factors deterministic for tests
    and checkpoint round-trips."""
    s = jnp.where(jnp.diagonal(R) < 0, -1.0, 1.0).astype(R.dtype)
    return s[:, None] * R


def chol_factor(sigma: Array) -> Array:
    """Lower Cholesky factor of a PSD matrix — entry point for converting a dense
    covariance into square-root form once, at the filter boundary."""
    return jnp.linalg.cholesky(sigma)


def sqrt_predict_factor(L: Array, A: Array, L_q: Array) -> Array:
    """Predicted factor: chol(A Σ Aᵀ + Q) from L = chol(Σ), L_q = chol(Q)."""
    pre = jnp.concatenate([L.T @ A.T, L_q.T], axis=0)  # (2n, n)
    R = jnp.linalg.qr(pre, mode="r")
    return _sign_fix(R).T


def sqrt_innovate_factor(
    mu: Array, L: Array, H: Array, L_r: Array, resid: Array
) -> tuple[Array, Array]:
    """Measurement update in factor form.

    Args: belief mean ``mu`` and factor ``L``; observation Jacobian ``H`` (m, n);
    ``L_r`` = chol(R_obs); ``resid`` = z − h(mu).  Returns (mu⁺, L⁺).
    """
    m = H.shape[0]
    n = L.shape[0]
    pre = jnp.block(
        [
            [L_r.T, jnp.zeros((m, n), L.dtype)],
            [L.T @ H.T, L.T],
        ]
    )  # (m+n, m+n)
    R = _sign_fix(jnp.linalg.qr(pre, mode="r"))
    X = R[:m, :m]  # upper; XᵀX = S = HΣHᵀ + R
    Y = R[:m, m:]  # XᵀY = HΣ
    Z = R[m:, m:]  # ZᵀZ = Σ − ΣHᵀS⁻¹HΣ
    # K = ΣHᵀS⁻¹ = Yᵀ X⁻ᵀ  ⇔  Kᵀ = X⁻¹ Y
    K = jsl.solve_triangular(X, Y, lower=False).T
    return mu + K @ resid, _sign_fix(Z).T


class SqrtEKF:
    """Square-root twin of :class:`trajopt_jax.core.ekf.EKF` over a belief env.

    Same predict/innovate/inference API, but the covariance argument/return is the
    lower Cholesky factor ``L`` (Σ = L Lᵀ).  Use :func:`chol_factor` once on the
    env's initial covariance to enter factor form.  No jitters anywhere — PSD-ness
    is structural, which is the defensible f32 formulation (the dense EKF
    needs 1e-5-relative floors in f32, core/ekf.py:_inv)."""

    def __init__(self, env):
        self.env = env

    def predict(self, mu_b: Array, L_b: Array, u: Array) -> tuple[Array, Array]:
        A = jax.jacfwd(self.env.dynamics, argnums=0)(mu_b, u)
        L_q = jnp.linalg.cholesky(self.env.dyn_noise(mu_b, u))
        return self.env.dynamics(mu_b, u), sqrt_predict_factor(L_b, A, L_q)

    def innovate(self, mu_b: Array, L_b: Array, z: Array) -> tuple[Array, Array]:
        H = jax.jacfwd(self.env.observe)(mu_b)
        L_r = jnp.linalg.cholesky(self.env.obs_noise(mu_b))
        resid = z - self.env.observe(mu_b)
        return sqrt_innovate_factor(mu_b, L_b, H, L_r, resid)

    def inference(self, mu_b: Array, L_b: Array, u: Array, z: Array):
        mu_b, L_b = self.predict(mu_b, L_b, u)
        return self.innovate(mu_b, L_b, z)
