import jax.numpy as jnp
import numpy as np

import trajopt_jax
from trajopt_jax.core.belief import (
    BeliefCostExpansion,
    BeliefDynamicsExpansion,
    belief_dynamics_expansion,
    bsp_backward,
)
from trajopt_jax.core.ekf import EKF, belief_ekf_step
from trajopt_jax.solvers.bspilqr import BSPiLQR


def bsp_backward_np(Q, q, R, r, P, p, F, G, X, Y, Z, T_, U, V, lmbda, reg):
    """NumPy oracle of bspilqr/src/util.cpp:83-204 (with tau_{t+1} in the e-row,
    fixing the uninitialized-memory read at util.cpp:158)."""
    T = F.shape[0]
    b, a = F.shape[-1], G.shape[-1]
    S = np.zeros((T + 1, b, b))
    s = np.zeros((T + 1, b))
    tau = np.zeros((T + 1, b * b))
    K = np.zeros((T, a, b))
    kff = np.zeros((T, a))
    dS = np.zeros(2)

    S[T], s[T], tau[T] = Q[T], q[T], p[T]
    for t in range(T - 1, -1, -1):
        C = Q[t] + F[t].T @ S[t + 1] @ F[t]
        D = R[t] + G[t].T @ S[t + 1] @ G[t]
        E = (P[t] + F[t].T @ S[t + 1] @ G[t]).T

        vecS = S[t + 1].reshape(-1)
        c = q[t] + F[t].T @ s[t + 1] + T_[t].T @ tau[t + 1] + 0.5 * X[t].T @ vecS
        d = r[t] + G[t].T @ s[t + 1] + V[t].T @ tau[t + 1] + 0.5 * Z[t].T @ vecS
        e = p[t] + U[t].T @ tau[t + 1] + 0.5 * Y[t].T @ vecS

        S_reg = S[t + 1] + (lmbda * np.eye(b) if reg == 2 else 0.0)
        E_reg = (P[t] + F[t].T @ S_reg @ G[t]).T
        D_reg = R[t] + G[t].T @ S_reg @ G[t] + (lmbda * np.eye(a) if reg == 1 else 0.0)

        Di = np.linalg.inv(D_reg)
        K[t] = -Di @ E_reg
        kff[t] = -Di @ d
        dS += np.array([kff[t] @ d, 0.5 * kff[t] @ D @ kff[t]])

        tau[t] = e
        s[t] = c + K[t].T @ D @ kff[t] + K[t].T @ d + E.T @ kff[t]
        S[t] = C + K[t].T @ D @ K[t] + K[t].T @ E + E.T @ K[t]
        S[t] = 0.5 * (S[t] + S[t].T)
    return K, kff, S, s, tau, dS


def test_bsp_backward_matches_numpy_oracle():
    rng = np.random.default_rng(11)
    T, b, a = 9, 2, 2

    def spd(d, scale=1.0):
        M = rng.standard_normal((d, d))
        return scale * (M @ M.T + d * np.eye(d))

    Q = np.stack([spd(b) for _ in range(T + 1)])
    q = rng.standard_normal((T + 1, b))
    R = np.stack([spd(a, 0.5) for _ in range(T + 1)])
    r = rng.standard_normal((T + 1, a))
    P = 0.1 * rng.standard_normal((T + 1, b, a))
    p = rng.standard_normal((T + 1, b * b))

    F = np.stack([np.eye(b) + 0.05 * rng.standard_normal((b, b)) for _ in range(T)])
    G = 0.1 * rng.standard_normal((T, b, a))
    X = 0.01 * rng.standard_normal((T, b * b, b))
    Y = 0.01 * rng.standard_normal((T, b * b, b * b))
    Z = 0.01 * rng.standard_normal((T, b * b, a))
    T_ = 0.01 * rng.standard_normal((T, b * b, b))
    U = 0.01 * rng.standard_normal((T, b * b, b * b))
    V = 0.01 * rng.standard_normal((T, b * b, a))

    ref = bsp_backward_np(Q, q, R, r, P, p, F, G, X, Y, Z, T_, U, V, 0.3, 1)

    cost = BeliefCostExpansion(
        Q=jnp.asarray(Q), q=jnp.asarray(q), R=jnp.asarray(R), r=jnp.asarray(r),
        P=jnp.asarray(P), p=jnp.asarray(p),
    )
    dyn = BeliefDynamicsExpansion(
        F=jnp.asarray(F), G=jnp.asarray(G), X=jnp.asarray(X), Y=jnp.asarray(Y),
        Z=jnp.asarray(Z), T=jnp.asarray(T_), U=jnp.asarray(U), V=jnp.asarray(V),
    )
    lc, S, s, tau, dS, diverged = bsp_backward(cost, dyn, 0.3, 1)

    assert not bool(diverged)
    for got, want in zip([lc.K, lc.kff, S, s, tau, dS], ref):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-8, atol=1e-10)


def test_native_bsp_backward_cross_validates_jax():
    """The independent C++ belief-value backward recursion (the bench.py CPU
    denominator for the bsp config) must agree with the JAX scan kernel for
    both regularization modes."""
    from trajopt_jax.utils.native import bsp_backward_native

    rng = np.random.default_rng(23)
    T, b, a = 9, 2, 2

    def spd(d, scale=1.0):
        M = rng.standard_normal((d, d))
        return scale * (M @ M.T + d * np.eye(d))

    cost = BeliefCostExpansion(
        Q=jnp.asarray(np.stack([spd(b) for _ in range(T + 1)])),
        q=jnp.asarray(rng.standard_normal((T + 1, b))),
        R=jnp.asarray(np.stack([spd(a, 0.5) for _ in range(T + 1)])),
        r=jnp.asarray(rng.standard_normal((T + 1, a))),
        P=jnp.asarray(0.1 * rng.standard_normal((T + 1, b, a))),
        p=jnp.asarray(rng.standard_normal((T + 1, b * b))),
    )
    dyn = BeliefDynamicsExpansion(
        F=jnp.asarray(np.stack(
            [np.eye(b) + 0.05 * rng.standard_normal((b, b)) for _ in range(T)]
        )),
        G=jnp.asarray(0.1 * rng.standard_normal((T, b, a))),
        X=jnp.asarray(0.01 * rng.standard_normal((T, b * b, b))),
        Y=jnp.asarray(0.01 * rng.standard_normal((T, b * b, b * b))),
        Z=jnp.asarray(0.01 * rng.standard_normal((T, b * b, a))),
        T=jnp.asarray(0.01 * rng.standard_normal((T, b * b, b))),
        U=jnp.asarray(0.01 * rng.standard_normal((T, b * b, b * b))),
        V=jnp.asarray(0.01 * rng.standard_normal((T, b * b, a))),
    )

    for reg, lmbda in [(1, 0.3), (2, 0.7)]:
        lc, _, _, _, dS, diverged = bsp_backward(cost, dyn, lmbda, reg)
        assert not bool(diverged)
        K_c, kff_c, dS_c, fail = bsp_backward_native(cost, dyn, lmbda, reg)
        assert fail == 0
        np.testing.assert_allclose(K_c, np.asarray(lc.K), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            kff_c, np.asarray(lc.kff), rtol=1e-10, atol=1e-12
        )
        np.testing.assert_allclose(dS_c, np.asarray(dS), rtol=1e-10, atol=1e-12)


def test_belief_dynamics_expansion_is_consistent():
    """Finite-difference check of the vmapped belief-dynamics Jacobian."""
    env = trajopt_jax.make("LightDark-TO-v0")
    b = env.belief_dim
    mu = jnp.array([2.0, 2.0])
    sigma = jnp.array([[5.0, 0.0], [0.0, 1e-8]])
    u = jnp.array([0.3, -0.2])

    exp = belief_dynamics_expansion(env, mu[None], sigma[None], u[None])

    eps = 1e-6
    f0, W0, phi0 = belief_ekf_step(env, mu, sigma, u)
    for i in range(b):
        dmu = mu.at[i].add(eps)
        f1, W1, phi1 = belief_ekf_step(env, dmu, sigma, u)
        np.testing.assert_allclose(
            np.asarray(exp.F[0][:, i]), np.asarray((f1 - f0) / eps), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(exp.T[0][:, i]),
            np.asarray((phi1 - phi0) / eps).reshape(-1),
            atol=1e-4,
        )


def test_bspilqr_lightdark_golden():
    """Headline BSP-iLQR behavior on light-dark: the plan actively collapses
    uncertainty before homing to the goal.

    Note: with the env's state clipping (lightdark.py:59 in the reference), the
    linearized dynamics gain A -> 0 at the state boundary, which offers the optimizer
    a second route to variance collapse besides visiting the light at x = 5 — both the
    reference's autograd clip and ours share this property, so the test asserts the
    information-gathering *outcome* (variance collapse + homing), not the route.
    """
    env = trajopt_jax.make("LightDark-TO-v0")
    solver = BSPiLQR(env, nb_steps=10, init_belief=env.init())
    trace = solver.run(nb_iter=25)

    assert np.isfinite(trace[-1])
    assert trace[-1] < 0.5 * trace[0]

    mu = np.asarray(solver.bref_mu)
    sigma = np.asarray(solver.bref_sigma)
    # uncertainty collapse: terminal x-variance orders of magnitude below initial 5
    assert sigma[-1, 0, 0] < 1e-3
    # homing: terminal mean near the goal
    assert np.linalg.norm(mu[-1]) < 0.5


def test_ekf_estimates_state():
    import jax

    env = trajopt_jax.make("LightDark-TO-v0")
    ekf = EKF(env)
    key = jax.random.PRNGKey(0)

    mu, sigma = env.init()
    x = env.reset_state()
    # drive toward the light where observations are informative
    for t in range(8):
        u = jnp.array([0.5, 0.0])
        key, k = jax.random.split(key)
        x, z = env.step(k, x, u)
        mu, sigma = ekf.inference(mu, sigma, u, z)

    assert float(sigma[0, 0]) < 0.05
    # x-component tracks (informative near the light); the y-prior is deliberately
    # overconfident and wrong in this env (init sigma_yy = 1e-8, lightdark.py:103-107),
    # so the filter correctly never corrects it
    np.testing.assert_allclose(float(mu[0]), float(x[0]), atol=0.4)
