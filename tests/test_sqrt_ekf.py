"""Square-root (Cholesky-factor) EKF: equivalence with the dense Joseph-form EKF
in f64, differentiability under jacfwd, structural PSD-ness in f32, and the
compiled belief-MPC runner's ``belief_filter="sqrt"`` path."""

import jax
import jax.numpy as jnp
import numpy as np

import trajopt_jax
from trajopt_jax.core.ekf import EKF
from trajopt_jax.core.sqrt_ekf import (
    SqrtEKF,
    chol_factor,
    sqrt_innovate_factor,
    sqrt_predict_factor,
)


def test_sqrt_matches_dense_ekf_f64():
    """Over a light-dark trajectory the factor filter reproduces the dense EKF
    (whose jitters/floors are no-ops in f64) to roundoff."""
    env = trajopt_jax.make("LightDark-TO-v0")
    dense, sqrt = EKF(env), SqrtEKF(env)

    mu_d, sig_d = env.init()
    mu_s, L = mu_d, chol_factor(sig_d)

    rng = np.random.default_rng(0)
    for _ in range(8):
        u = jnp.asarray(rng.uniform(-1.0, 1.0, size=2))
        z = env.observe(env.dynamics(mu_d, u)) + jnp.asarray(
            0.05 * rng.standard_normal(2)
        )
        mu_d, sig_d = dense.inference(mu_d, sig_d, u, z)
        mu_s, L = sqrt.inference(mu_s, L, u, z)
        assert np.allclose(mu_s, mu_d, atol=1e-9)
        assert np.allclose(L @ L.T, sig_d, atol=1e-9)
        # factor stays lower-triangular with non-negative diagonal (sign-fixed)
        assert np.allclose(np.triu(np.asarray(L), 1), 0.0)
        assert np.all(np.diag(np.asarray(L)) >= 0.0)


def test_sqrt_inference_jacfwd_finite():
    """jacfwd through the QR-array update is well-defined (the eigh-clamping
    alternative is not) — required because BSP belief dynamics differentiate
    through the filter step."""
    env = trajopt_jax.make("LightDark-TO-v0")
    sqrt = SqrtEKF(env)
    mu0, sigma0 = env.init()
    L0 = chol_factor(sigma0)
    u = jnp.array([0.3, -0.2])
    z = jnp.array([2.2, 1.9])

    J = jax.jacfwd(lambda mu: sqrt.inference(mu, L0, u, z)[0])(mu0)
    assert J.shape == (2, 2)
    assert bool(jnp.all(jnp.isfinite(J)))
    JL = jax.jacfwd(lambda L: sqrt.inference(mu0, L, u, z)[1])(L0)
    assert bool(jnp.all(jnp.isfinite(JL)))


def test_sqrt_update_f32_structurally_psd():
    """In f32, with a near-singular channel at the reference's 1e-8 noise floor,
    the factor update stays exactly PSD (Σ = L Lᵀ by construction) and tracks the
    f64 oracle to f32 precision — the regime where the dense difference form
    D − KHD loses definiteness in f32 (core/ekf.py:_inv docstring)."""
    rng = np.random.default_rng(1)
    n = 3
    G = rng.standard_normal((n, n))
    sigma = G @ G.T + np.eye(n)
    sigma[2, :] = sigma[:, 2] = 0.0
    sigma[2, 2] = 1e-8  # collapsed channel
    H = np.eye(n)
    R = 1e-8 * np.eye(n)
    mu = np.zeros(n)
    resid = rng.standard_normal(n)

    def run(dtype):
        L = jnp.linalg.cholesky(jnp.asarray(sigma, dtype))
        L_r = jnp.linalg.cholesky(jnp.asarray(R, dtype))
        mu_p, L_p = sqrt_innovate_factor(
            jnp.asarray(mu, dtype), L, jnp.asarray(H, dtype), L_r,
            jnp.asarray(resid, dtype),
        )
        return np.asarray(mu_p), np.asarray(L_p)

    mu64, L64 = run(jnp.float64)
    mu32, L32 = run(jnp.float32)
    assert L32.dtype == np.float32
    post32 = L32 @ L32.T
    assert np.all(np.linalg.eigvalsh(post32.astype(np.float64)) >= 0.0)
    assert np.allclose(mu32, mu64, atol=1e-4)
    assert np.allclose(post32, L64 @ L64.T, atol=1e-6)


def test_sqrt_predict_factor_matches_dense():
    rng = np.random.default_rng(2)
    n = 4
    G = rng.standard_normal((n, n))
    sigma = G @ G.T + np.eye(n)
    A = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    Q = 0.01 * np.eye(n)
    L = sqrt_predict_factor(
        jnp.linalg.cholesky(jnp.asarray(sigma)),
        jnp.asarray(A),
        jnp.linalg.cholesky(jnp.asarray(Q)),
    )
    assert np.allclose(L @ L.T, A @ sigma @ A.T + Q, atol=1e-10)


def test_mpc_runner_sqrt_filter_matches_joseph():
    """The compiled light-dark MPC episode is filter-form-invariant in f64."""
    from trajopt_jax.parallel.bsp import make_bsp_mpc_runner

    env = trajopt_jax.make("LightDark-TO-v0")
    key = jax.random.PRNGKey(3)
    x0 = env.reset_state()

    run_j = make_bsp_mpc_runner(env, horizon=5, nb_steps=3, nb_iter=2)
    run_s = make_bsp_mpc_runner(
        env, horizon=5, nb_steps=3, nb_iter=2, belief_filter="sqrt"
    )
    out_j = jax.jit(run_j)(key, x0)
    out_s = jax.jit(run_s)(key, x0)
    for a, b in zip(out_j, out_s):
        assert np.allclose(a, b, atol=1e-8), np.abs(np.asarray(a - b)).max()
