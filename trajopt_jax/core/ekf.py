"""Extended-Kalman mean/covariance propagation through a nonlinear env under a
linear-Gaussian controller.

JAX equivalent of ``AnalyticalLinearGaussianDynamics.extended_kalman``
(gps/objects.py:179-212).  The reference runs two Python loops with per-step autograd;
here: one ``lax.scan`` for the mean path, one vmapped jacfwd for the linearization,
one ``lax.scan`` for the covariance recursion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..core.diff import linearize_dynamics
from ..core.types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    symmetrize,
)


def extended_kalman(
    env,
    policy: LinearGaussianPolicy,
    mu0: Array,
    sigma0: Array,
) -> tuple[GaussianSequence, GaussianSequence, LinearGaussianDynamics]:
    """Propagate N(mu0, sigma0) through the deterministic env mean dynamics and the
    EKF covariance recursion; relinearize along the mean path.

    Returns (xdist (T+1), udist (T), lgd) exactly as gps/objects.py:179-212: action
    means are clipped to the env limits, covariances are symmetrized each step.
    """
    T = policy.horizon
    ulim = env.ulim

    # 1) mean rollout (sequential)
    def mean_step(mu, inp):
        K, kff = inp
        u = jnp.clip(K @ mu + kff, -ulim, ulim)
        mu_n = env.dynamics(mu, u)
        return mu_n, (mu, u)

    mu_T, (mu_xs, mu_us) = lax.scan(mean_step, mu0, (policy.K, policy.kff))
    mu_x = jnp.concatenate([mu_xs, mu_T[None]], axis=0)

    # 2) batched linearization + noise along the mean path
    lin = linearize_dynamics(env.dynamics, mu_xs, mu_us)
    sigma_dyn = jax.vmap(env.noise)(mu_xs, mu_us)
    lgd = LinearGaussianDynamics(A=lin.A, B=lin.B, c=lin.c, sigma=sigma_dyn)

    # 3) covariance recursion (sequential)
    def cov_step(sigma_x, inp):
        A, B, sig_dyn, K, ctl_sigma = inp
        u_sigma = symmetrize(ctl_sigma + K @ sigma_x @ K.T)
        AB = jnp.concatenate([A, B], axis=1)
        cross = sigma_x @ K.T
        sigma_xu = jnp.block([[sigma_x, cross], [cross.T, u_sigma]])
        sigma_xn = symmetrize(sig_dyn + AB @ sigma_xu @ AB.T)
        return sigma_xn, (sigma_x, u_sigma)

    sig_T, (sig_xs, sig_us) = lax.scan(
        cov_step, sigma0, (lin.A, lin.B, sigma_dyn, policy.K, policy.sigma)
    )
    sigma_x = jnp.concatenate([sig_xs, sig_T[None]], axis=0)

    xdist = GaussianSequence(mu=mu_x, sigma=sigma_x)
    udist = GaussianSequence(mu=mu_us, sigma=sig_us)
    return xdist, udist, lgd


def belief_ekf_step(env, mu_b: Array, sigma_b: Array, u: Array):
    """One EKF predict + gain step of the *belief dynamics* — returns
    (f, W, Φ) = (mean dynamics, Kalman update covariance KHD, predicted-minus-update
    covariance D − KHD), mirroring ``AnalyticalLinearBeliefDynamics.dynamics``
    (bspilqr/objects.py:213-233)."""
    A = jax.jacfwd(env.dynamics, argnums=0)(mu_b, u)
    f = env.dynamics(mu_b, u)
    H = jax.jacfwd(env.observe)(f)

    sigma_dyn = env.dyn_noise(mu_b, u)
    sigma_obs = env.obs_noise(f)

    D = symmetrize(A @ sigma_b @ A.T + sigma_dyn)
    S = H @ D @ H.T + sigma_obs
    K = D @ H.T @ _inv(S)

    W = K @ H @ D
    # Joseph form of D − KHD (identical for the optimal gain, but guaranteed PSD
    # in f32 — the plain difference cancels catastrophically in f32 and
    # produced negative variances on the car task)
    I_KH = jnp.eye(D.shape[0], dtype=D.dtype) - K @ H
    phi = _psd_floor(symmetrize(I_KH @ D @ I_KH.T + K @ sigma_obs @ K.T))
    return f, W, phi


def _psd_floor(M: Array) -> Array:
    """Relative diagonal floor, f32 only (no-op in f64 — the reference's own
    1e-8 noise floors suffice there).

    Belief envs observe some channels noiselessly, so the posterior covariance
    collapses to exact singularity in f32; differentiating the next EKF step
    through its Cholesky then yields NaN Jacobians.
    """
    if M.dtype != jnp.float32:
        return M
    d = M.shape[-1]
    scale = jnp.trace(M) / d + jnp.asarray(1e-12, M.dtype)
    return M + 1e-5 * scale * jnp.eye(d, dtype=M.dtype)


def _inv(S: Array) -> Array:
    """Innovation-covariance inverse via Cholesky.

    In f32 a *relative* jitter is added first: belief envs follow the reference
    in using a 1e-8 absolute noise floor (car.py:86-89), which underflows against
    O(1) covariances in f32 and makes S exactly singular on the channels the
    light-dark profile leaves noiseless (observed: NaNs on the car task in f32).
    The jitter is zero in f64, where the reference's own floor suffices.
    """
    from ..utils.psd import inv_psd

    S = symmetrize(S)
    if S.dtype == jnp.float32:
        d = S.shape[-1]
        scale = jnp.trace(S) / d + jnp.asarray(1e-12, S.dtype)
        S = S + 1e-5 * scale * jnp.eye(d, dtype=S.dtype)
    return inv_psd(S)


class EKF:
    """Classic EKF over a belief env — mirror of bspilqr/objects.py:24-73,
    used by the BSP-iLQR MPC drivers (examples/bspilqr/lightdark.py:34-45)."""

    def __init__(self, env):
        self.env = env

    def predict(self, mu_b, sigma_b, u):
        A = jax.jacfwd(self.env.dynamics, argnums=0)(mu_b, u)
        sigma = symmetrize(A @ sigma_b @ A.T + self.env.dyn_noise(mu_b, u))
        return self.env.dynamics(mu_b, u), sigma

    def innovate(self, mu_b, sigma_b, z):
        H = jax.jacfwd(self.env.observe)(mu_b)
        R = self.env.obs_noise(mu_b)
        S = H @ sigma_b @ H.T + R
        K = sigma_b @ H.T @ _inv(S)
        mu = mu_b + K @ (z - self.env.observe(mu_b))
        # Joseph form (see belief_ekf_step): PSD-stable in f32
        I_KH = jnp.eye(sigma_b.shape[0], dtype=sigma_b.dtype) - K @ H
        sigma = _psd_floor(symmetrize(I_KH @ sigma_b @ I_KH.T + K @ R @ K.T))
        return mu, sigma

    def inference(self, mu_b, sigma_b, u, z):
        mu_b, sigma_b = self.predict(mu_b, sigma_b, u)
        return self.innovate(mu_b, sigma_b, z)
