"""Tests for the fully-compiled robust GPS (parallel/rgps.py) against the host
solvers (solvers/rgps.py, themselves oracle-tested in test_rgps.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.parallel.rgps import make_rgps_solver
from trajopt_jax.solvers.rgps import LRGPS

KW = dict(
    nb_steps=20, init_action_sigma=10.0, policy_kl_bound=0.25,
    param_nominal_kl_bound=50.0, nominal_variance=1e-8,
)


def test_compiled_lrgps_matches_host():
    """Same geometric β-bisection, same fixed point, same acceptance — the
    compiled solver must land on the host's β* and trace exactly."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()

    solve = jax.jit(make_rgps_solver(env, variant="lr", nb_iter=5, **KW))
    state, trace = solve(jnp.asarray(mu0), jnp.asarray(sigma0))

    host = LRGPS(
        env, init_state=env.init(), param_regularizer_kl_bound=10.0, **KW
    )
    host_trace = host.run(nb_iter=5)

    # β-bisections agree exactly; the policy dual differs only by its optimizer
    # (log-α bisection vs the host's L-BFGS-B), hence the ~1e-7 trace tolerance
    np.testing.assert_allclose(np.asarray(trace), np.asarray(host_trace), rtol=1e-5)
    np.testing.assert_allclose(float(state.beta), host.beta, rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(state.ctl.K), np.asarray(host.ctl.K), rtol=1e-3, atol=1e-6
    )


def test_adversary_ablation():
    """Robust-vs-standard (the reference's own regression harness,
    examples/rgps/mb_lqr.py:53-111): the adversary must change the controller,
    and disabling it must recover the faster nominal descent."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    m = (jnp.asarray(mu0), jnp.asarray(sigma0))

    s_on, tr_on = jax.jit(make_rgps_solver(env, variant="lr", nb_iter=5, **KW))(*m)
    s_off, tr_off = jax.jit(
        make_rgps_solver(env, variant="lr", nb_iter=5, optimize_adversary=False, **KW)
    )(*m)

    assert float(jnp.max(jnp.abs(s_on.ctl.K - s_off.ctl.K))) > 1e-2
    # nominal optimization descends at least as fast on the nominal objective
    assert float(tr_off[-1]) <= float(tr_on[-1])
    assert np.all(np.diff(np.asarray(tr_on)) <= 1e-6)


@pytest.mark.slow
def test_compiled_mbrgps_runs_on_pendulum():
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05, sigma_scale=1e-4)
    mu0, sigma0 = env.init()
    solve = jax.jit(make_rgps_solver(
        env, nb_steps=20, variant="mb", nb_iter=3, init_action_sigma=1.0,
        policy_kl_bound=1.0, param_nominal_kl_bound=10.0, nominal_variance=1e-8,
    ))
    state, trace = solve(jnp.asarray(mu0), jnp.asarray(sigma0))
    tr = np.asarray(trace)
    assert np.all(np.isfinite(tr))
    assert np.all(np.diff(tr) <= 1e-6)


def test_compiled_mfrgps_improves():
    """Compiled model-free robust GPS: sampled rollouts + meanfield MatrixNormal
    nominal + learned noise inside the compiled min-max loop (rgps/mfrgps.py)."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    solve = jax.jit(make_rgps_solver(
        env, nb_steps=20, variant="mf", nb_iter=4, init_action_sigma=5.0,
        policy_kl_bound=1.0, param_nominal_kl_bound=50.0, nb_episodes=20,
    ))
    state, trace = solve(
        jnp.asarray(mu0), jnp.asarray(sigma0), jax.random.PRNGKey(3)
    )
    tr = np.asarray(trace)
    assert np.all(np.isfinite(tr))
    assert np.all(np.diff(tr) <= 1e-6)
    assert tr[-1] < tr[0]
    assert float(state.beta) < 1.0  # adversary active within the KL ball


def test_rgps_batch_sharded_matches_unsharded():
    """run_rgps_batch with the problem axis sharded over the 8-device CPU mesh
    must reproduce the unsharded result (the batched-RGPS DP axis of SURVEY.md
    config #5)."""
    from jax.sharding import Mesh

    from trajopt_jax.parallel.rgps import run_rgps_batch

    env = trajopt_jax.make("LQR-TO-v1", sigma_scale=1e-4)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))

    kwargs = dict(nb_problems=8, nb_steps=15, variant="lr", nb_iter=2,
                  init_action_sigma=10.0, policy_kl_bound=1.0)
    data = run_rgps_batch(env, jax.random.PRNGKey(5), mesh=mesh, **kwargs)
    ref = run_rgps_batch(env, jax.random.PRNGKey(5), mesh=None, **kwargs)

    assert data["trace"].shape == (8, 3)
    assert np.all(np.isfinite(np.asarray(data["trace"])))
    np.testing.assert_allclose(np.asarray(data["trace"]), np.asarray(ref["trace"]),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(data["K"]), np.asarray(ref["K"]),
                               rtol=1e-6, atol=1e-8)


def test_compiled_stepwise_policy_dual_matches_host():
    """policy_kl_stepwise=True: the compiled damped multiplicative log-α fixed
    point must land on the host L-BFGS-B vector dual's stationarity system
    KL_t(α) = bound ∀t (mbrgps.py:678-702) — same pattern as the compiled
    stepwise GPS dual (test_gps_compiled.py)."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()

    solve = jax.jit(make_rgps_solver(
        env, variant="lr", nb_iter=4, policy_kl_stepwise=True, **KW
    ))
    state, trace = solve(jnp.asarray(mu0), jnp.asarray(sigma0))
    assert state.alpha.shape == (KW["nb_steps"],)

    host = LRGPS(
        env, init_state=env.init(), policy_kl_stepwise=True,
        param_regularizer_kl_bound=10.0, **KW,
    )
    host_trace = host.run(nb_iter=4)

    tr = np.asarray(trace)
    assert np.all(np.isfinite(tr))
    # both optimizers satisfy the same per-t constraint system; the β-bisection
    # agrees exactly, the policy dual only through its stationarity system
    np.testing.assert_allclose(tr, np.asarray(host_trace), rtol=1e-3)
    np.testing.assert_allclose(float(state.beta), host.beta, rtol=1e-6)


def test_compiled_regularized_adversary_matches_host():
    """iterative_adversary=True: the compiled masked-scan regularized adversary
    (reguarlized_parameter_optimization, mbrgps.py:633-676) must land on the
    host's iterated small-KL attack and trace.  VERDICT r2 #5."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    kw = dict(
        nb_steps=20, init_action_sigma=10.0, policy_kl_bound=0.25,
        param_nominal_kl_bound=50.0, nominal_variance=1e-8,
    )

    solve = jax.jit(make_rgps_solver(
        env, variant="lr", nb_iter=3, iterative_adversary=True,
        param_regularizer_kl_bound=10.0, **kw,
    ))
    state, trace = solve(jnp.asarray(mu0), jnp.asarray(sigma0))

    host = LRGPS(env, init_state=env.init(), param_regularizer_kl_bound=10.0, **kw)
    host_trace = host.run(nb_iter=3, iterative_adversary=True)

    np.testing.assert_allclose(np.asarray(trace), np.asarray(host_trace), rtol=1e-4)
    np.testing.assert_allclose(float(state.beta), host.eta, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(state.ctl.K), np.asarray(host.ctl.K), rtol=1e-3, atol=1e-6
    )


def test_parallel_beta_search_matches_bisect():
    """beta_search='parallel' (the vmapped grid-then-refine dual, VERDICT r3
    item 3) must land inside the same 10% acceptance band and produce a
    solution equivalent to the sequential bisection (the selected beta may
    differ within the band, so the comparison is on duals and traces, not
    bitwise)."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    m = (jnp.asarray(mu0), jnp.asarray(sigma0))

    s_b, tr_b = jax.jit(make_rgps_solver(env, variant="lr", nb_iter=3, **KW))(*m)
    s_p, tr_p = jax.jit(
        make_rgps_solver(
            env, variant="lr", nb_iter=3, beta_search="parallel", **KW
        )
    )(*m)

    assert bool(jnp.all(jnp.isfinite(tr_p)))
    # same dual within the band resolution, near-identical descent
    np.testing.assert_allclose(
        np.asarray(tr_p), np.asarray(tr_b), rtol=2e-2
    )
    assert float(s_p.beta) > 0.0
    np.testing.assert_allclose(
        np.log10(float(s_p.beta)), np.log10(float(s_b.beta)), atol=1.0
    )


def test_parallel_alpha_search_matches_bisect():
    """alpha_search='parallel' (K-ary bracket refinement of the policy dual)
    must satisfy the same KL constraint and give an equivalent descent."""
    env = trajopt_jax.make("LQR-TO-v1")
    mu0, sigma0 = env.init()
    m = (jnp.asarray(mu0), jnp.asarray(sigma0))

    s_b, tr_b = jax.jit(make_rgps_solver(env, variant="lr", nb_iter=3, **KW))(*m)
    s_p, tr_p = jax.jit(
        make_rgps_solver(
            env, variant="lr", nb_iter=3, beta_search="parallel",
            alpha_search="parallel", **KW
        )
    )(*m)
    assert bool(jnp.all(jnp.isfinite(tr_p)))
    np.testing.assert_allclose(np.asarray(tr_p), np.asarray(tr_b), rtol=2e-2)
