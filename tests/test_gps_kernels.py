import jax.numpy as jnp
import numpy as np

from trajopt_jax.core.scan_lqr import (
    augment_cost_kl,
    gaussian_forward,
    gaussian_interp_kl,
    gaussian_kl,
    gps_backward,
    policy_kl,
    quad_expectation,
)
from trajopt_jax.core.types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    QuadraticCost,
)

from ref_impl import (
    augment_cost_np,
    gaussian_forward_np,
    gps_backward_np,
    kl_divergence_np,
    random_quadratic_problem,
)


def _random_policy(rng, T, dx, du):
    K = 0.1 * rng.standard_normal((T, du, dx))
    kff = 0.1 * rng.standard_normal((T, du))
    sigma = np.stack(
        [np.eye(du) + 0.1 * np.diag(rng.random(du)) for _ in range(T)]
    )
    return K, kff, sigma


def test_gps_backward_matches_numpy_oracle():
    rng = np.random.default_rng(3)
    T, dx, du = 23, 3, 2
    p = random_quadratic_problem(rng, T, dx, du, gaussian=True)
    alpha = 10.0 ** rng.uniform(1, 3, size=T)

    K_np, kff_np, sig_np, V_np, v_np, v0_np, div_np = gps_backward_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["c0"],
        p["A"], p["B"], p["c"], p["sigma_dyn"], alpha,
    )
    assert not div_np

    cost = QuadraticCost(*[jnp.asarray(p[k]) for k in ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]])
    dyn = LinearGaussianDynamics(
        A=jnp.asarray(p["A"]), B=jnp.asarray(p["B"]), c=jnp.asarray(p["c"]),
        sigma=jnp.asarray(p["sigma_dyn"]),
    )
    lgc, value, qvalue, diverged = gps_backward(cost, dyn, jnp.asarray(alpha))

    assert not bool(diverged)
    np.testing.assert_allclose(np.asarray(lgc.K), K_np, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(lgc.kff), kff_np, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(lgc.sigma), sig_np, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(value.V), V_np, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(value.v), v_np, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(value.v0), v0_np, rtol=1e-8, atol=1e-8)


def test_gaussian_forward_matches_numpy_oracle():
    rng = np.random.default_rng(4)
    T, dx, du = 17, 3, 2
    p = random_quadratic_problem(rng, T, dx, du, gaussian=True)
    K, kff, sigma = _random_policy(rng, T, dx, du)
    mu0 = rng.standard_normal(dx)
    sigma0 = np.eye(dx) * 0.5

    ref = gaussian_forward_np(
        mu0, sigma0, p["A"], p["B"], p["c"], p["sigma_dyn"], K, kff, sigma
    )

    dyn = LinearGaussianDynamics(
        A=jnp.asarray(p["A"]), B=jnp.asarray(p["B"]), c=jnp.asarray(p["c"]),
        sigma=jnp.asarray(p["sigma_dyn"]),
    )
    lgc = LinearGaussianPolicy(K=jnp.asarray(K), kff=jnp.asarray(kff), sigma=jnp.asarray(sigma))
    xdist, udist, xudist = gaussian_forward(dyn, lgc, jnp.asarray(mu0), jnp.asarray(sigma0))

    for got, want in zip(
        [xdist.mu, xdist.sigma, udist.mu, udist.sigma, xudist.mu, xudist.sigma], ref
    ):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_augment_cost_matches_numpy_oracle():
    rng = np.random.default_rng(5)
    T, dx, du = 11, 3, 2
    p = random_quadratic_problem(rng, T, dx, du)
    K, kff, sigma = _random_policy(rng, T, dx, du)
    alpha = 10.0 ** rng.uniform(-1, 2, size=T)

    ref = augment_cost_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["c0"], K, kff, sigma, alpha
    )

    cost = QuadraticCost(*[jnp.asarray(p[k]) for k in ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]])
    lgc = LinearGaussianPolicy(K=jnp.asarray(K), kff=jnp.asarray(kff), sigma=jnp.asarray(sigma))
    ag = augment_cost_kl(cost, lgc, jnp.asarray(alpha))

    for got, want in zip([ag.Cxx, ag.cx, ag.Cuu, ag.cu, ag.Cxu, ag.c0], ref):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_policy_kl_matches_numpy_oracle():
    rng = np.random.default_rng(6)
    T, dx, du = 13, 3, 2
    pK, pk, psig = _random_policy(rng, T, dx, du)
    qK, qk, qsig = _random_policy(rng, T, dx, du)
    mu_x = rng.standard_normal((T + 1, dx))
    sigma_x = np.stack([np.eye(dx) * (1 + i * 0.01) for i in range(T + 1)])

    ref = kl_divergence_np(pK, pk, psig, qK, qk, qsig, mu_x, sigma_x)

    p = LinearGaussianPolicy(K=jnp.asarray(pK), kff=jnp.asarray(pk), sigma=jnp.asarray(psig))
    q = LinearGaussianPolicy(K=jnp.asarray(qK), kff=jnp.asarray(qk), sigma=jnp.asarray(qsig))
    xdist = GaussianSequence(mu=jnp.asarray(mu_x), sigma=jnp.asarray(sigma_x))

    np.testing.assert_allclose(np.asarray(policy_kl(p, q, xdist)), ref, rtol=1e-9, atol=1e-12)

    # KL(p, p) == 0
    np.testing.assert_allclose(np.asarray(policy_kl(p, p, xdist)), 0.0, atol=1e-10)


def test_quad_expectation():
    rng = np.random.default_rng(8)
    d = 4
    mu = rng.standard_normal(d)
    M = rng.standard_normal((d, d))
    sigma = M @ M.T + np.eye(d)
    V = rng.standard_normal((d, d))
    v = rng.standard_normal(d)
    v0 = 1.3

    got = quad_expectation(
        jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(V), jnp.asarray(v), v0
    )
    want = mu @ V @ mu + mu @ v + v0 + np.trace(V @ sigma)
    np.testing.assert_allclose(float(got), want, rtol=1e-10)

    # Monte-Carlo cross-check
    xs = rng.multivariate_normal(mu, sigma, size=1_000_000)
    mc = np.mean(np.einsum("ni,ij,nj->n", xs, V, xs) + xs @ v + v0)
    np.testing.assert_allclose(float(got), mc, rtol=5e-2, atol=5e-2)


def test_gaussian_kl_and_interp():
    rng = np.random.default_rng(9)
    T, d = 7, 3
    mus = rng.standard_normal((2, T, d))
    sigs = np.stack(
        [[np.eye(d) + 0.3 * np.diag(rng.random(d)) for _ in range(T)] for _ in range(2)]
    )
    p = GaussianSequence(mu=jnp.asarray(mus[0]), sigma=jnp.asarray(sigs[0]))
    q = GaussianSequence(mu=jnp.asarray(mus[1]), sigma=jnp.asarray(sigs[1]))

    kl_pp = gaussian_kl(p, p)
    np.testing.assert_allclose(np.asarray(kl_pp), 0.0, atol=1e-10)
    assert np.all(np.asarray(gaussian_kl(p, q)) > 0)

    # interpolation endpoints
    interp0 = gaussian_interp_kl(q, p, 0.0)
    np.testing.assert_allclose(np.asarray(interp0.mu), mus[1], rtol=1e-8)
    np.testing.assert_allclose(np.asarray(interp0.sigma), sigs[1], rtol=1e-8)
    interp1 = gaussian_interp_kl(q, p, 1.0)
    np.testing.assert_allclose(np.asarray(interp1.mu), mus[0], rtol=1e-8)
    np.testing.assert_allclose(np.asarray(interp1.sigma), sigs[0], rtol=1e-8)


def test_gaussian_interp_w2_matches_numpy_oracle():
    """W2-geodesic interpolation (core/scan_lqr.gaussian_interp_w2) vs an
    independent scipy.linalg.sqrtm oracle implementing the reference's
    interp_gauss_w2 (rgps/mbrgps.py:561-577, kernel rgps/src/util.cpp:155-185)."""
    import scipy.linalg

    from trajopt_jax.core.scan_lqr import gaussian_interp_w2

    rng = np.random.default_rng(21)
    T, d = 6, 3
    a = 0.37
    mus = rng.standard_normal((2, T, d))
    sigs = np.zeros((2, T, d, d))
    for i in range(2):
        for t in range(T):
            R = rng.standard_normal((d, d))
            sigs[i, t] = R @ R.T + 0.5 * np.eye(d)

    q = GaussianSequence(mu=jnp.asarray(mus[0]), sigma=jnp.asarray(sigs[0]))
    p = GaussianSequence(mu=jnp.asarray(mus[1]), sigma=jnp.asarray(sigs[1]))
    got = gaussian_interp_w2(q, p, a)

    for t in range(T):
        mu_o = (1.0 - a) * mus[0, t] + a * mus[1, t]
        s_chol = np.real(scipy.linalg.sqrtm(sigs[0, t]))
        s_chol_inv = np.linalg.inv(s_chol)
        mid = (1.0 - a) * sigs[0, t] + a * np.real(
            scipy.linalg.sqrtm(s_chol @ sigs[1, t] @ s_chol)
        )
        sig_o = s_chol_inv @ mid @ mid @ s_chol_inv
        np.testing.assert_allclose(np.asarray(got.mu)[t], mu_o, rtol=1e-8)
        np.testing.assert_allclose(
            np.asarray(got.sigma)[t], sig_o, rtol=1e-6, atol=1e-8
        )

    # endpoints
    interp0 = gaussian_interp_w2(q, p, 0.0)
    np.testing.assert_allclose(np.asarray(interp0.mu), mus[0], rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(interp0.sigma), sigs[0], rtol=1e-6, atol=1e-8
    )
    interp1 = gaussian_interp_w2(q, p, 1.0)
    np.testing.assert_allclose(np.asarray(interp1.mu), mus[1], rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(interp1.sigma), sigs[1], rtol=1e-6, atol=1e-8
    )
