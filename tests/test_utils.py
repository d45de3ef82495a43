import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.solvers import Riccati, iLQR
from trajopt_jax.utils import checkpoint
from trajopt_jax.utils.metrics import MetricsRecorder
from trajopt_jax.utils.native import ilqr_backward_native

from ref_impl import ilqr_backward_np, random_quadratic_problem


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solver = iLQR(env, nb_steps=30, init_state=jnp.asarray(env.x0),
                  action_penalty=1e-5)
    solver.run(nb_iter=5)

    checkpoint.save(tmp_path / "ckpt", solver)

    fresh = iLQR(env, nb_steps=30, init_state=jnp.asarray(env.x0),
                 action_penalty=1e-5)
    checkpoint.restore(tmp_path / "ckpt", fresh)

    np.testing.assert_allclose(np.asarray(fresh.xref), np.asarray(solver.xref))
    np.testing.assert_allclose(np.asarray(fresh.ctl.K), np.asarray(solver.ctl.K))
    assert fresh.lmbda == solver.lmbda
    assert fresh.last_return == solver.last_return

    # resumed solver continues improving from the restored state (run() re-applies
    # the restored controller's alpha-grid init sweep, so trace[0] is near but not
    # necessarily below the stored return)
    trace = fresh.run(nb_iter=3)
    assert np.isfinite(trace[-1])
    assert trace[-1] <= trace[0]


def test_metrics_recorder():
    m = MetricsRecorder("gps")
    m.log(0, kl=1.0, ret=100.0)
    m.log(1, kl=0.9, ret=90.0)
    assert m.history("ret") == [100.0, 90.0]
    assert "ret" in m.table()
    assert len(m.to_jsonl().splitlines()) == 2


def test_native_kernel_cross_validates_jax():
    """The independent C++ implementation and the numpy oracle agree — a
    second-opinion check on the kernel math."""
    rng = np.random.default_rng(77)
    p = random_quadratic_problem(rng, T=31, dx=3, du=2)

    K_np, kff_np, *_ , div = ilqr_backward_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"], 0.7, 1
    )
    assert not div
    K_c, kff_c, fail = ilqr_backward_native(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"], 0.7
    )
    assert fail == 0
    np.testing.assert_allclose(K_c, K_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(kff_c, kff_np, rtol=1e-12, atol=1e-12)


def test_native_gps_dual_chain_cross_validates_jax():
    """The independent C++ GPS dual-evaluation chain (augment -> soft-KL backward
    -> Gaussian forward -> KL/expectation, the bench.py CPU denominator for the
    gps config) must agree with the JAX scan kernels."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.scan_lqr import (
        augment_cost_kl,
        gaussian_forward,
        gps_backward,
        policy_kl,
        quad_expectation,
    )
    from trajopt_jax.core.types import (
        LinearGaussianDynamics,
        LinearGaussianPolicy,
        QuadraticCost,
    )
    from trajopt_jax.utils.native import gps_dual_chain_native

    rng = np.random.default_rng(3)
    T, dx, du = 30, 3, 2

    def spd(d, n, s=1.0):
        M = rng.standard_normal((n, d, d))
        return s * np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    cost = QuadraticCost(
        Cxx=jnp.asarray(spd(dx, T + 1)),
        cx=jnp.asarray(rng.standard_normal((T + 1, dx))),
        Cuu=jnp.asarray(spd(du, T + 1)),
        cu=jnp.asarray(rng.standard_normal((T + 1, du))),
        Cxu=jnp.asarray(0.1 * rng.standard_normal((T + 1, dx, du))),
        c0=jnp.asarray(rng.standard_normal(T + 1)),
    )
    dyn = LinearGaussianDynamics(
        A=jnp.asarray(0.9 * (np.eye(dx) + 0.05 * rng.standard_normal((T, dx, dx)))),
        B=jnp.asarray(0.1 * rng.standard_normal((T, dx, du))),
        c=jnp.asarray(0.01 * rng.standard_normal((T, dx))),
        sigma=jnp.asarray(1e-4 * spd(dx, T)),
    )
    pol = LinearGaussianPolicy(
        K=jnp.asarray(0.1 * rng.standard_normal((T, du, dx))),
        kff=jnp.asarray(0.1 * rng.standard_normal((T, du))),
        sigma=jnp.asarray(spd(du, T)),
    )
    alpha = jnp.asarray(np.full(T, 25.0))
    mu0 = jnp.asarray(rng.standard_normal(dx))
    sigma0 = jnp.asarray(spd(dx, 1)[0] * 0.1)

    ag = augment_cost_kl(cost, pol, alpha)
    lgc, value, _, div = gps_backward(ag, dyn, alpha)
    assert not bool(div)
    xdist, _, _ = gaussian_forward(dyn, lgc, mu0, sigma0)
    kl = policy_kl(lgc, pol, jax.tree.map(lambda x: x[:-1], xdist))
    dual_jax = quad_expectation(mu0, sigma0, value.V[0], value.v[0], value.v0[0])

    dual_c, kl_c, fail = gps_dual_chain_native(
        cost.Cxx, cost.cx, cost.Cuu, cost.cu, cost.Cxu, cost.c0,
        dyn.A, dyn.B, dyn.c, dyn.sigma,
        pol.K, pol.kff, pol.sigma, alpha, mu0, sigma0,
    )
    assert fail == 0
    np.testing.assert_allclose(dual_c, float(dual_jax), rtol=1e-9)
    np.testing.assert_allclose(kl_c, float(jnp.sum(kl)), rtol=1e-9)


def test_native_rgps_fixed_point_cross_validates_jax():
    """The independent C++ RGPS adversary fixed-point trip (parameter backward
    pass + cubature forward + KL + damping, the bench.py CPU denominator for
    the rgps config) must agree with the JAX cubature kernels."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.cubature import (
        cubature_forward_pass,
        parameter_augment_cost,
        parameter_backward_pass,
    )
    from trajopt_jax.core.scan_lqr import gaussian_interp_kl, gaussian_kl
    from trajopt_jax.core.types import (
        LinearGaussianPolicy,
        MatrixNormalParams,
        QuadraticCost,
        vec_from_matrices,
    )
    from trajopt_jax.utils.native import rgps_fixed_point_native

    rng = np.random.default_rng(11)
    T, dx, du = 15, 3, 2
    p = dx * (dx + du + 1)

    def spd(d, n, s=1.0):
        M = rng.standard_normal((n, d, d))
        return s * np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    cost = QuadraticCost(
        Cxx=jnp.asarray(spd(dx, T + 1)),
        cx=jnp.asarray(rng.standard_normal((T + 1, dx))),
        Cuu=jnp.asarray(spd(du, T + 1)),
        cu=jnp.asarray(rng.standard_normal((T + 1, du))),
        Cxu=jnp.asarray(0.1 * rng.standard_normal((T + 1, dx, du))),
        c0=jnp.asarray(rng.standard_normal(T + 1)),
    )
    A = 0.9 * (np.eye(dx) + 0.05 * rng.standard_normal((T, dx, dx)))
    B = 0.1 * rng.standard_normal((T, dx, du))
    c = 0.01 * rng.standard_normal((T, dx))
    theta = jax.vmap(vec_from_matrices)(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c)
    )
    nominal = MatrixNormalParams(
        mu=theta, sigma=jnp.asarray(np.tile(1e-4 * np.eye(p), (T, 1, 1)))
    )
    ctl = LinearGaussianPolicy(
        K=jnp.asarray(0.05 * rng.standard_normal((T, du, dx))),
        kff=jnp.asarray(0.05 * rng.standard_normal((T, du))),
        sigma=jnp.asarray(np.tile(np.eye(du), (T, 1, 1))),
    )
    noise = jnp.asarray(1e-4 * spd(dx, T))
    mu0 = jnp.asarray(rng.standard_normal(dx))
    sigma0 = jnp.asarray(0.01 * spd(dx, 1)[0])
    beta = jnp.asarray(200.0)

    agCpp, agcp, _ = parameter_augment_cost(nominal, jnp.asarray(100.0))
    q, _, _ = cubature_forward_pass(mu0, sigma0, nominal, noise, ctl)

    param, _, div = parameter_backward_pass(
        q, ctl, noise, cost, agCpp, agcp, beta
    )
    assert not bool(div)
    p_xdist, _, _ = cubature_forward_pass(mu0, sigma0, param, noise, ctl)
    kl_jax = float(jnp.sum(gaussian_kl(p_xdist, q)))
    q_new = gaussian_interp_kl(q, p_xdist, 1e-1)

    mu_opt, pmu, psig, kl_c, qmu_new, qsig_new, fail = rgps_fixed_point_native(
        cost.Cxx, cost.cx, cost.Cuu, cost.cu, cost.Cxu, cost.c0,
        ctl.K, ctl.kff, ctl.sigma, noise, agCpp, agcp, float(beta),
        q.mu, q.sigma, mu0, sigma0, interp_a=0.1,
    )
    assert fail == 0
    np.testing.assert_allclose(mu_opt, np.asarray(param.mu), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pmu, np.asarray(p_xdist.mu), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        psig, np.asarray(p_xdist.sigma), rtol=1e-8, atol=1e-12
    )
    np.testing.assert_allclose(kl_c, kl_jax, rtol=1e-8)
    np.testing.assert_allclose(qmu_new, np.asarray(q_new.mu), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        qsig_new, np.asarray(q_new.sigma), rtol=1e-8, atol=1e-12
    )


def test_chained_timing_and_roofline():
    """The timer reports a median inside its spread, and the roofline
    accounting must be self-consistent and take its peaks from the caller."""
    import jax
    import jax.numpy as jnp
    import pytest

    from trajopt_jax.utils.profiling import backward_roofline, seconds_per_call

    M = jnp.ones((64, 64))
    med, (lo, hi) = seconds_per_call(jax.jit(lambda a: a @ a), (M,), repeats=5)
    assert 0 < lo <= med <= hi

    r = backward_roofline(1e-3, batch=1024, T=1000, dx=4, du=2,
                          hbm_peak_gbs=3350.0, flop_peak_tflops=67.0)
    assert r["timesteps_per_s"] == 1024 * 1000 / 1e-3
    assert 0 < r["hbm_fraction"] < 10
    assert 0 < r["flop_fraction"] < 10
    with pytest.raises(TypeError):
        backward_roofline(1e-3, batch=1024, T=1000, dx=4, du=2)


def test_make_mesh_shapes():
    import jax

    from trajopt_jax.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert mesh.axis_names == ("dp",)
    assert mesh.devices.size == len(jax.devices())

    mesh2 = make_mesh(("dp", "time"), (4, 2))
    assert mesh2.shape == {"dp": 4, "time": 2}


def test_viz_surface():
    """Solver observability plots (reference plot/plot_distributions/plot_dual
    parity) render without a display."""
    import matplotlib

    matplotlib.use("Agg")
    import jax
    import jax.numpy as jnp

    import trajopt_jax
    from trajopt_jax.core.types import GaussianSequence, MatrixNormalParams
    from trajopt_jax.utils import viz

    T, d, a = 10, 2, 1
    xdist = GaussianSequence(
        mu=jnp.zeros((T + 1, d)), sigma=jnp.tile(jnp.eye(d), (T + 1, 1, 1))
    )
    udist = GaussianSequence(
        mu=jnp.zeros((T, a)), sigma=jnp.tile(jnp.eye(a), (T, 1, 1))
    )
    fig = viz.plot_gaussian_trajectory(xdist, udist, show=False)
    assert len(fig.axes) == d + a

    fig = viz.plot_reference_trajectory(
        jnp.zeros((T + 1, d)), jnp.zeros((T, a)), show=False
    )
    assert len(fig.axes) == d + a

    fig = viz.plot_belief_trajectory(
        xdist.mu, xdist.sigma, jnp.zeros((T, a)), show=False
    )
    assert len(fig.axes) == d + a

    param = MatrixNormalParams(
        mu=jnp.zeros((T, 6)), sigma=jnp.tile(jnp.eye(6), (T, 1, 1))
    )
    fig = viz.plot_matrixnormal_marginals(param, 3, show=False)
    assert len(fig.axes) == 6

    fig = viz.plot_dual_landscape(lambda x: float(x) ** 0.5, opt=10.0, show=False)
    assert len(fig.axes) == 1

    # solver-attached surface
    env = trajopt_jax.make("LQR-TO-v0")
    from trajopt_jax.solvers import Riccati

    ric = Riccati(env, nb_steps=10, init_state=env.init())
    ric.run()
    fig = ric.plot(show=False)
    assert len(fig.axes) == 3


def test_host_solver_metrics_match_trace():
    """Every host solver run() logs through its MetricsRecorder; the accepted-
    iteration 'ret' history must equal the returned trace (VERDICT r2 #8)."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solver = iLQR(env, nb_steps=12, init_state=env.x0)
    trace = solver.run(nb_iter=4)

    hist = solver.metrics.history("ret")
    np.testing.assert_allclose(hist, trace, rtol=1e-12)
    assert all(r["accepted"] for r in solver.metrics.records if "ret" in r)
    assert solver.metrics.table()  # renders

    # gps: same contract
    from trajopt_jax.solvers.gps import MBGPS

    genv = trajopt_jax.make("LQR-TO-v0", sigma_scale=1e-4)
    gps = MBGPS(genv, nb_steps=10, init_state=genv.init(), kl_bound=5.0)
    gtrace = gps.run(nb_iter=2)
    np.testing.assert_allclose(gps.metrics.history("ret"), gtrace, rtol=1e-12)

    # history describes the LATEST run — a second run() must not accumulate
    # records from the first (the recorder is reset/re-created on entry)
    trace2 = solver.run(nb_iter=4)
    np.testing.assert_allclose(solver.metrics.history("ret"), trace2, rtol=1e-12)
    gtrace2 = gps.run(nb_iter=2)
    np.testing.assert_allclose(gps.metrics.history("ret"), gtrace2, rtol=1e-12)


def test_compiled_solver_structured_metrics():
    """metrics=True switches the compiled iLQR trace to a per-iteration pytree."""
    import jax.numpy as jnp
    from trajopt_jax.parallel.mpc import ILQRIterMetrics, make_ilqr_solver, \
        make_ilqr_solver_batched

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solve = make_ilqr_solver(env, nb_steps=12, nb_iter=4, metrics=True)
    state, m = solve(jnp.asarray(env.x0))
    assert isinstance(m, ILQRIterMetrics)
    assert m.ret.shape == (4,) and m.lmbda.shape == (4,) and m.done.shape == (4,)
    np.testing.assert_allclose(float(m.ret[-1]), float(state.last_return))

    plain = make_ilqr_solver(env, nb_steps=12, nb_iter=4)
    _, tr = plain(jnp.asarray(env.x0))
    np.testing.assert_allclose(np.asarray(m.ret), np.asarray(tr))

    bsolve = make_ilqr_solver_batched(env, nb_steps=12, nb_iter=4, metrics=True)
    x0s = jnp.tile(jnp.asarray(env.x0), (3, 1))
    bstate, bm = bsolve(x0s)
    assert bm.ret.shape == (4, 3)
    np.testing.assert_allclose(np.asarray(bm.ret[-1]), np.asarray(bstate.last_return))


def test_bench_failed_rows_land_in_json():
    """A bench row that raises must land in the emitted JSON line's
    ``failed_rows`` field (VERDICT r4 item 2: round 4's flagship BSP row
    vanished from the record with rc=0 because the failure only hit stderr)."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        from bench import _try_bench
    finally:
        sys.path.pop(0)

    extras, failed = {}, {}
    _try_bench(extras, failed, "good_row", lambda: 41.96)

    def boom():
        raise RuntimeError("Triton failed to compile kernel: forced")

    _try_bench(extras, failed, "flagship_row", boom)

    assert extras == {"good_row": 42.0}
    assert "flagship_row" in failed and "forced" in failed["flagship_row"]

    result = {"metric": "m", "value": 1.0, "extras": extras}
    if failed:
        result["failed_rows"] = failed
    line = json.dumps(result)
    assert "flagship_row" in line and "RuntimeError" in line
