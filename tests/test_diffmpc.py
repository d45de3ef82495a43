"""Differentiable compiled iLQR (parallel/diffmpc.py, mpc.py differentiable=True).

The reference has no gradient path through its solver at all (Python loop around
pybind kernels, ilqr/ilqr.py:136-237); these tests pin the beyond-reference
capability: (1) the differentiable mode is a semantics-preserving rewrite of the
default compiled solver, (2) reverse-mode gradients w.r.t. the initial state and
w.r.t. environment (cost) parameters match central finite differences on the
exact same compiled computation.
"""

import jax
import jax.numpy as jnp
import numpy as np

import trajopt_jax
from trajopt_jax.parallel.diffmpc import make_ilqr_solver_diff
from trajopt_jax.parallel.mpc import make_ilqr_solver_batched


def _x0s(env, n, seed=0):
    rng = np.random.default_rng(seed)
    base = np.asarray(env.x0, dtype=np.float64)
    return jnp.asarray(base[None] + 0.05 * rng.standard_normal((n, base.size)))


def test_differentiable_mode_matches_default_solver():
    """differentiable=True must reproduce the while_loop solver exactly when the
    λ escalation terminates within lm_steps trips (it is a masked fixed-length
    rewrite of the same loop)."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    x0s = _x0s(env, 3)

    ref = jax.jit(make_ilqr_solver_batched(env, nb_steps=25, nb_iter=6))
    dif = jax.jit(
        make_ilqr_solver_batched(
            env, nb_steps=25, nb_iter=6, differentiable=True, lm_steps=24
        )
    )
    s_ref, tr_ref = ref(x0s)
    s_dif, tr_dif = dif(x0s)

    np.testing.assert_allclose(np.asarray(tr_dif), np.asarray(tr_ref), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_dif.uref), np.asarray(s_ref.uref), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(s_dif.xref), np.asarray(s_ref.xref), atol=1e-12
    )


def test_grad_x0_matches_finite_differences():
    """d(converged cost)/d(x0) through the full solve vs central differences.

    LQR keeps the solve smooth in x0 (no accept/reject branch flips between
    FD evaluation points)."""
    env = trajopt_jax.make("LQR-TO-v0")
    solve = make_ilqr_solver_diff(env, nb_steps=20, nb_iter=3)

    def loss(x0s):
        state, _ = solve(x0s)
        return jnp.sum(state.last_return)

    loss_j = jax.jit(loss)
    x0s = _x0s(env, 2, seed=1)
    g = np.asarray(jax.jit(jax.grad(loss))(x0s))

    eps = 1e-6
    fd = np.zeros_like(g)
    for i in range(x0s.shape[0]):
        for j in range(x0s.shape[1]):
            e = jnp.zeros_like(x0s).at[i, j].set(eps)
            fd[i, j] = (float(loss_j(x0s + e)) - float(loss_j(x0s - e))) / (2 * eps)

    np.testing.assert_allclose(g, fd, rtol=1e-5, atol=1e-7)


def test_grad_env_params_matches_finite_differences():
    """Inverse-optimal-control gradient: d(loss on the converged trajectory)/
    d(cost weights) via env.replace with traced leaves, vs central differences."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solve = make_ilqr_solver_diff(
        env,
        nb_steps=20,
        nb_iter=4,
        param_apply=lambda e, p: e.replace(gw=p),
    )
    x0s = _x0s(env, 2, seed=2)
    u_star = jnp.ones((2, 20, env.dm_act), jnp.float64)

    def loss(p):
        state, _ = solve(x0s, p)
        return jnp.mean((state.uref - u_star) ** 2)

    loss_j = jax.jit(loss)
    p0 = jnp.asarray([1.0, 0.1], jnp.float64)
    g = np.asarray(jax.jit(jax.grad(loss))(p0))

    eps = 1e-6
    fd = np.zeros_like(g)
    for j in range(p0.size):
        e = jnp.zeros_like(p0).at[j].set(eps)
        fd[j] = (float(loss_j(p0 + e)) - float(loss_j(p0 - e))) / (2 * eps)

    assert np.all(np.abs(g) > 0.0)
    np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-10)


def test_differentiable_requires_scan_engines():
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    try:
        make_ilqr_solver_batched(
            env, nb_steps=10, differentiable=True, backward="pallas"
        )
    except ValueError as e:
        assert "differentiable" in str(e)
    else:  # pragma: no cover
        raise AssertionError("expected ValueError for pallas + differentiable")


def test_grad_through_compiled_elqr_matches_fd():
    """The compiled eLQR (parallel/elqr.py) is built from scans/linearizations
    only — reverse-differentiable out of the box; pin it against FD."""
    from trajopt_jax.parallel.elqr import make_elqr_solver

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solve = make_elqr_solver(env, 15, nb_iter=4)

    def loss(x0):
        _, _, uref, _ = solve(jax.random.PRNGKey(0), x0)
        return jnp.sum(uref**2)

    loss_j = jax.jit(loss)
    x0 = jnp.asarray(np.asarray(env.x0)) + 0.03
    g = np.asarray(jax.jit(jax.grad(loss))(x0))

    eps = 1e-6
    fd = np.zeros_like(g)
    for i in range(x0.size):
        e = jnp.zeros_like(x0).at[i].set(eps)
        fd[i] = (float(loss_j(x0 + e)) - float(loss_j(x0 - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-6)


def test_grad_through_batched_riccati_matches_fd():
    """Exact-LQR solve (parallel/riccati.py): d(total cost)/d(x0) through the
    whole backward-pass + rollout program vs FD."""
    from trajopt_jax.parallel.riccati import make_riccati_solver_batched

    env = trajopt_jax.make("LQR-TO-v0")
    solve = make_riccati_solver_batched(env, 30)

    def loss(x0s):
        _, _, _, costs, _ = solve(x0s)
        return jnp.sum(costs)

    loss_j = jax.jit(loss)
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(rng.standard_normal((2, env.dm_state)))
    g = np.asarray(jax.jit(jax.grad(loss))(x0s))

    eps = 1e-6
    fd = np.zeros_like(g)
    for i in range(x0s.shape[0]):
        for j in range(x0s.shape[1]):
            e = jnp.zeros_like(x0s).at[i, j].set(eps)
            fd[i, j] = (float(loss_j(x0s + e)) - float(loss_j(x0s - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-6)


def test_gps_implicit_dual_grad_matches_fd():
    """make_mbgps_solver(differentiable=True): the KL-dual bisection is
    piecewise-constant, so plain AD drops dα*/dθ — the custom_vjp implicit
    function theorem on KL(α*)=ε restores the exact gradient.  Pinned against
    FD and against primal equality with the default solver."""
    from trajopt_jax.parallel.gps import make_mbgps_solver

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)

    def make_loss(diff):
        def loss(p):
            e = env.replace(gw=p)
            solve = make_mbgps_solver(
                e, 15, nb_iter=3, kl_bound=2.0, differentiable=diff
            )
            mu0, sigma0 = e.init()
            _, trace = solve(jax.random.PRNGKey(0), mu0, sigma0)
            return trace[-1]

        return loss

    p0 = jnp.asarray([1.0, 0.1], jnp.float64)
    plain = jax.jit(make_loss(False))
    diff = jax.jit(make_loss(True))
    np.testing.assert_allclose(float(diff(p0)), float(plain(p0)), rtol=0)

    g = np.asarray(jax.jit(jax.grad(make_loss(True)))(p0))
    eps = 1e-6
    fd = np.zeros_like(g)
    for j in range(p0.size):
        e = jnp.zeros_like(p0).at[j].set(eps)
        fd[j] = (float(plain(p0 + e)) - float(plain(p0 - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5)

    # plain AD through the bisection must NOT match (the sensitivity it drops
    # is real) — guards against the test silently weakening
    g_plain = np.asarray(jax.jit(jax.grad(make_loss(False)))(p0))
    assert not np.allclose(g_plain, fd, rtol=1e-3)


def test_rgps_differentiable_matches_default_and_fd():
    """make_rgps_solver(differentiable=True): the adversary fixed-point
    while_loop becomes a condition-gated fixed-length scan (exact rewrite — the
    gated scan reproduces the while_loop's final state whether or not the fixed
    point converges within fp_iters), and the policy α-bisection gets the same
    implicit-function-theorem custom_vjp as GPS.  Primal equality is exact;
    d(robust expected cost)/d(mu0) through the full min-max solve is pinned
    against central differences."""
    from trajopt_jax.parallel.rgps import make_rgps_solver

    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(np.asarray(mu0), jnp.float64)
    sigma0 = jnp.asarray(np.asarray(sigma0), jnp.float64)
    kw = dict(
        nb_steps=10, variant="lr", nb_iter=2, init_action_sigma=10.0,
        policy_kl_bound=0.25, param_nominal_kl_bound=50.0,
        beta_iters=6, fp_iters=12, alpha_bisect_iters=32,
    )

    ref = jax.jit(make_rgps_solver(env, **kw))
    dif = jax.jit(make_rgps_solver(env, differentiable=True, **kw))
    s_ref, tr_ref = ref(mu0, sigma0)
    s_dif, tr_dif = dif(mu0, sigma0)
    np.testing.assert_allclose(np.asarray(tr_dif), np.asarray(tr_ref), rtol=1e-12)
    np.testing.assert_allclose(float(s_dif.beta), float(s_ref.beta), rtol=0)
    np.testing.assert_allclose(
        np.asarray(s_dif.ctl.K), np.asarray(s_ref.ctl.K), atol=1e-12
    )

    solve = make_rgps_solver(env, differentiable=True, **kw)

    def loss(m0):
        _, trace = solve(m0, sigma0)
        return trace[-1]

    loss_j = jax.jit(loss)
    g = np.asarray(jax.jit(jax.grad(loss))(mu0))
    assert np.all(np.isfinite(g)) and np.any(np.abs(g) > 0.0)

    eps = 1e-6
    fd = np.zeros_like(g)
    for i in range(mu0.size):
        e = jnp.zeros_like(mu0).at[i].set(eps)
        fd[i] = (float(loss_j(mu0 + e)) - float(loss_j(mu0 - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-8)


def test_rgps_differentiable_iterative_adversary_smoke():
    """differentiable=True composes with iterative_adversary=True: the
    regularized small-KL adversary's η-bisections are already scans, and its
    fixed-point solves go through the same gated-scan rewrite — primal must
    equal the default solver exactly, and the gradient stay finite."""
    from trajopt_jax.parallel.rgps import make_rgps_solver

    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(np.asarray(mu0), jnp.float64)
    sigma0 = jnp.asarray(np.asarray(sigma0), jnp.float64)
    kw = dict(
        nb_steps=8, variant="lr", nb_iter=1, init_action_sigma=10.0,
        policy_kl_bound=0.25, param_nominal_kl_bound=50.0,
        iterative_adversary=True, param_regularizer_kl_bound=10.0,
        eta_iters=4, reg_steps=3, fp_iters=8, alpha_bisect_iters=24,
    )

    _, tr_ref = jax.jit(make_rgps_solver(env, **kw))(mu0, sigma0)
    solve = make_rgps_solver(env, differentiable=True, **kw)
    _, tr_dif = jax.jit(solve)(mu0, sigma0)
    np.testing.assert_allclose(np.asarray(tr_dif), np.asarray(tr_ref), rtol=1e-12)

    g = np.asarray(
        jax.jit(jax.grad(lambda m: solve(m, sigma0)[1][-1]))(mu0)
    )
    assert np.all(np.isfinite(g)) and np.any(np.abs(g) > 0.0)


def test_bsp_differentiable_matches_default_and_fd():
    """make_bsp_solver(differentiable=True): exact rewrite of the compiled
    belief-space solver + FD-pinned gradients w.r.t. the initial belief mean
    and the belief-cost weights (planning sensitivities through the EKF)."""
    from trajopt_jax.parallel.bsp import make_bsp_solver

    env = trajopt_jax.make("LightDark-TO-v0")
    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(np.asarray(mu0), jnp.float64)
    sigma0 = jnp.asarray(np.asarray(sigma0), jnp.float64)

    ref = jax.jit(make_bsp_solver(env, 12, nb_iter=5))
    dif = jax.jit(make_bsp_solver(env, 12, nb_iter=5, differentiable=True,
                                  lm_steps=24))
    s_ref, tr_ref = ref(mu0, sigma0)
    s_dif, tr_dif = dif(mu0, sigma0)
    np.testing.assert_allclose(np.asarray(tr_dif), np.asarray(tr_ref), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_dif.uref), np.asarray(s_ref.uref), atol=1e-12
    )

    def loss(m0, w):
        e = env.replace(mu_w=w)
        solve = make_bsp_solver(e, 12, nb_iter=4, differentiable=True)
        state, _ = solve(m0, sigma0)
        return state.last_return

    loss_j = jax.jit(loss)
    w0 = jnp.asarray([0.5, 0.5], jnp.float64)
    g_mu, g_w = jax.jit(jax.grad(loss, argnums=(0, 1)))(mu0, w0)

    eps = 1e-6
    for k in range(2):
        e = jnp.zeros_like(mu0).at[k].set(eps)
        fd = (float(loss_j(mu0 + e, w0)) - float(loss_j(mu0 - e, w0))) / (2 * eps)
        np.testing.assert_allclose(float(g_mu[k]), fd, rtol=1e-4, atol=1e-8)
        ew = jnp.zeros_like(w0).at[k].set(eps)
        fdw = (float(loss_j(mu0, w0 + ew)) - float(loss_j(mu0, w0 - ew))) / (2 * eps)
        np.testing.assert_allclose(float(g_w[k]), fdw, rtol=1e-4, atol=1e-8)


def test_gps_stepwise_implicit_dual_grad_matches_fd():
    """make_mbgps_solver(differentiable=True, kl_stepwise=True): the T coupled
    constraints KL_t(α*) = ε get a dense (T, T) implicit solve in the
    custom_vjp (Cholesky normal equations).  Primal equality is exact; the
    gradient is pinned against central differences; plain AD must NOT match
    (the staircase sensitivity it drops is real)."""
    from trajopt_jax.parallel.gps import make_mbgps_solver

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)

    def make_loss(diff):
        def loss(p):
            e = env.replace(gw=p)
            solve = make_mbgps_solver(
                e, 12, nb_iter=3, kl_bound=0.2, kl_stepwise=True,
                differentiable=diff,
            )
            mu0, sigma0 = e.init()
            _, trace = solve(jax.random.PRNGKey(0), mu0, sigma0)
            return trace[-1]

        return loss

    p0 = jnp.asarray([1.0, 0.1], jnp.float64)
    plain = jax.jit(make_loss(False))
    diff = jax.jit(make_loss(True))
    np.testing.assert_allclose(float(diff(p0)), float(plain(p0)), rtol=0)

    g = np.asarray(jax.jit(jax.grad(make_loss(True)))(p0))
    assert np.all(np.isfinite(g)) and np.any(np.abs(g) > 0.0)
    eps = 1e-6
    fd = np.zeros_like(g)
    for j in range(p0.size):
        e = jnp.zeros_like(p0).at[j].set(eps)
        fd[j] = (float(plain(p0 + e)) - float(plain(p0 - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-10)

    # NOTE: unlike the scalar bracket bisection (comparison-based staircase),
    # the stepwise dual's damped multiplicative update is SMOOTH, so plain
    # unrolled AD also converges to the implicit derivative here — the
    # custom_vjp buys exactness at finite sweep counts and O(1) reverse-mode
    # memory in the sweep count, not correctness of the converged limit.
    g_plain = np.asarray(jax.jit(jax.grad(make_loss(False)))(p0))
    np.testing.assert_allclose(g_plain, fd, rtol=1e-3)


def test_rgps_stepwise_differentiable_grad_matches_fd():
    """make_rgps_solver(differentiable=True, policy_kl_stepwise=True): the
    stepwise policy dual's damped log-α fixed point gets the dense (T, T)
    implicit custom_vjp; d(robust cost)/d(mu0) pinned against FD."""
    from trajopt_jax.parallel.rgps import make_rgps_solver

    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(np.asarray(mu0), jnp.float64)
    sigma0 = jnp.asarray(np.asarray(sigma0), jnp.float64)
    kw = dict(
        nb_steps=8, variant="lr", nb_iter=2, init_action_sigma=10.0,
        policy_kl_bound=0.05, policy_kl_stepwise=True,
        param_nominal_kl_bound=50.0,
        beta_iters=6, fp_iters=12, alpha_bisect_iters=32,
    )

    ref = jax.jit(make_rgps_solver(env, **kw))
    solve = make_rgps_solver(env, differentiable=True, **kw)
    s_ref, tr_ref = ref(mu0, sigma0)
    _, tr_dif = jax.jit(solve)(mu0, sigma0)
    np.testing.assert_allclose(np.asarray(tr_dif), np.asarray(tr_ref), rtol=1e-12)
    assert s_ref.alpha.shape == (kw["nb_steps"],)

    def loss(m0):
        _, trace = solve(m0, sigma0)
        return trace[-1]

    loss_j = jax.jit(loss)
    g = np.asarray(jax.jit(jax.grad(loss))(mu0))
    assert np.all(np.isfinite(g)) and np.any(np.abs(g) > 0.0)

    eps = 1e-6
    fd = np.zeros_like(g)
    for i in range(mu0.size):
        e = jnp.zeros_like(mu0).at[i].set(eps)
        fd[i] = (float(loss_j(mu0 + e)) - float(loss_j(mu0 - e))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-8)
