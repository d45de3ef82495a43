"""f32 numerics guard shard (VERDICT r1 weak #8/#9).

The rest of the suite runs in f64 against f64 oracles; the f32 behavior of
the accelerator path, which required the matmul-precision and Joseph-form
fixes (CLAUDE.md invariants), is pinned here on the CPU backend inside
``jax.enable_x64(False)``: same dtypes as the GPU path (CPU arithmetic is
exact per-op, so failures here mean genuine f32 conditioning/underflow bugs,
not matmul-precision ones — that invariant is asserted directly on the
config).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax


def test_matmul_precision_invariant_is_set():
    """trajopt_jax/__init__.py must pin jax_default_matmul_precision=highest —
    reduced-precision matmul passes (TF32 on the GPU) corrupt the value
    recursions."""
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.fixture
def f32():
    with jax.enable_x64(False):
        yield


def test_gps_riccati_cross_oracle_f32(f32):
    """The reference's own oracle (mbgps_riccati.py:20-41) in f32: MBGPS and
    exact Riccati must agree on the LQR task's cost — the f32 twin of
    tests/test_gps.py::test_mbgps_matches_riccati_on_lqr."""
    from trajopt_jax.solvers import MBGPS, Riccati

    env = trajopt_jax.make("LQR-TO-v0")
    mbgps = MBGPS(env, nb_steps=100, init_state=env.init(),
                  init_action_sigma=100.0, kl_bound=5.0)
    trace = mbgps.run(nb_iter=15)

    riccati = Riccati(env, nb_steps=100, init_state=env.init())
    riccati.run()
    ric_cost = riccati.run()  # idempotent second sweep = exact optimum

    assert np.isfinite(trace[-1])
    np.testing.assert_allclose(trace[-1], ric_cost, rtol=3e-2)


def test_ekf_definiteness_at_1em8_noise_floor_f32(f32):
    """Joseph form + f32 relative jitters: filtering the car task (1e-8
    observation-noise floor, car.py:86-89) must keep the belief covariance
    finite and PD — the exact failure CLAUDE.md records for the naive update."""
    from trajopt_jax.core.ekf import EKF

    env = trajopt_jax.make("Car-TO-v0")
    filt = EKF(env)
    mu0, sigma0 = env.init()
    mu = jnp.asarray(mu0, jnp.float32)
    sigma = jnp.asarray(sigma0, jnp.float32)
    key = jax.random.PRNGKey(0)
    x = env.reset_state()

    for i in range(30):
        key, k1, k2 = jax.random.split(key, 3)
        u = 0.1 * jax.random.normal(k1, (env.act_dim,), jnp.float32)
        x, z = env.step(k2, x, u)
        mu, sigma = filt.inference(mu, sigma, u, z)

    assert np.all(np.isfinite(np.asarray(mu)))
    w = np.linalg.eigvalsh(np.asarray(sigma))
    assert np.all(w > 0), f"covariance lost definiteness: eigs {w}"


def test_sqrt_belief_pipeline_f32(f32):
    """Square-root end-to-end in f32: sqrt EKF in the loop + sqrt (S, s, τ)
    backward inside the solver (belief_filter='sqrt' + value_form='sqrt') on
    light-dark — finite trajectories, finite costs, PD beliefs."""
    from trajopt_jax.parallel.bsp import make_bsp_mpc_runner

    env = trajopt_jax.make("LightDark-TO-v0")
    run = jax.jit(make_bsp_mpc_runner(
        env, horizon=8, nb_steps=6, nb_iter=6,
        belief_filter="sqrt", value_form="sqrt",
    ))
    mu0, _ = env.init()
    xs, mus, sigmas, us, cs = run(jax.random.PRNGKey(3),
                                  jnp.asarray(np.array(mu0), jnp.float32))
    assert xs.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(xs)))
    assert np.all(np.isfinite(np.asarray(cs)))
    w = np.linalg.eigvalsh(np.asarray(sigmas))
    assert np.all(w > -1e-7)


def test_ilqr_pendulum_converges_f32(f32):
    """Full compiled iLQR swing-up in f32 reaches the same cost ballpark as the
    f64 suite (tests/test_ilqr.py) — guards the backward pass + line search
    against f32 conditioning regressions."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    solve = jax.jit(make_ilqr_solver(env, nb_steps=60, nb_iter=25))
    x0 = jnp.asarray(np.array(env.x0), jnp.float32)
    state, _ = solve(x0)
    ret = float(state.last_return)
    assert np.isfinite(ret)
    assert ret < 100.0  # f64 converged value ~86.35 (verify recipe)


def test_rgps_unrolled_chain_f32(f32):
    """The unrolled-linalg RGPS adversary chain in f32: one fixed-point trip
    on a small problem stays finite and matches the f64-path structure
    (guards chol_unrolled's NaN semantics and jitters in f32)."""
    from trajopt_jax.core.cubature import (
        cubature_forward_pass,
        parameter_augment_cost,
        parameter_backward_pass,
    )
    from trajopt_jax.core.types import (
        LinearGaussianPolicy,
        MatrixNormalParams,
        QuadraticCost,
    )

    rng = np.random.default_rng(3)
    T, dx, du = 10, 2, 1
    p1 = dx + du + 1
    p = dx * p1

    def spd(d, n, s):
        M = rng.standard_normal((n, d, d))
        return jnp.asarray(
            s * np.einsum("nij,nkj->nik", M, M) + d * np.eye(d), jnp.float32
        )

    cost = QuadraticCost(
        Cxx=spd(dx, T + 1, 0.1),
        cx=jnp.asarray(rng.standard_normal((T + 1, dx)), jnp.float32),
        Cuu=spd(du, T + 1, 1.0),
        cu=jnp.asarray(rng.standard_normal((T + 1, du)), jnp.float32),
        Cxu=jnp.zeros((T + 1, dx, du), jnp.float32),
        c0=jnp.zeros(T + 1, jnp.float32),
    )
    nominal = MatrixNormalParams(
        mu=jnp.asarray(0.1 * rng.standard_normal((T, p)), jnp.float32),
        sigma=jnp.broadcast_to(
            1e-4 * jnp.eye(p, dtype=jnp.float32), (T, p, p)
        ),
    )
    ctl = LinearGaussianPolicy(
        K=jnp.asarray(0.05 * rng.standard_normal((T, du, dx)), jnp.float32),
        kff=jnp.asarray(0.05 * rng.standard_normal((T, du)), jnp.float32),
        sigma=jnp.broadcast_to(jnp.eye(du, dtype=jnp.float32), (T, du, du)),
    )
    noise = jnp.broadcast_to(1e-4 * jnp.eye(dx, dtype=jnp.float32), (T, dx, dx))
    mu0 = jnp.zeros(dx, jnp.float32)
    sigma0 = 0.01 * jnp.eye(dx, dtype=jnp.float32)

    agCpp, agcp, _ = parameter_augment_cost(nominal, jnp.float32(100.0))
    xdist, _, _ = cubature_forward_pass(mu0, sigma0, nominal, noise, ctl)
    param, value, diverged = parameter_backward_pass(
        xdist, ctl, noise, cost, agCpp, agcp, jnp.float32(200.0)
    )
    assert param.mu.dtype == jnp.float32
    assert not bool(diverged)
    assert np.all(np.isfinite(np.asarray(param.mu)))
    assert np.all(np.isfinite(np.asarray(param.sigma)))
    w = np.linalg.eigvalsh(np.asarray(param.sigma))
    assert np.all(w > 0)
