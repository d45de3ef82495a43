import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajopt_jax.core.pscan_lqr import (
    pilqr_backward,
    priccati_backward,
    sharded_backward,
)
from trajopt_jax.core.scan_lqr import ilqr_backward, riccati_backward
from trajopt_jax.core.types import LinearDynamics, QuadraticCost

from ref_impl import random_quadratic_problem


def _pack(p):
    cost = QuadraticCost(
        Cxx=jnp.asarray(p["Cxx"]), cx=jnp.asarray(p["cx"]),
        Cuu=jnp.asarray(p["Cuu"]), cu=jnp.asarray(p["cu"]),
        Cxu=jnp.asarray(p["Cxu"]), c0=jnp.asarray(p["c0"]),
    )
    dyn = LinearDynamics(
        A=jnp.asarray(p["A"]), B=jnp.asarray(p["B"]), c=jnp.asarray(p["c"])
    )
    return cost, dyn


@pytest.mark.parametrize("T", [7, 64, 333])
def test_parallel_riccati_equals_sequential(T):
    """Property test (SURVEY.md §4): gains/value from the associative-scan path must
    equal the sequential scan to tight tolerance."""
    rng = np.random.default_rng(100 + T)
    p = random_quadratic_problem(rng, T, dx=3, du=2)
    cost, dyn = _pack(p)

    ctl_s, val_s = riccati_backward(cost, dyn)
    ctl_p, val_p = priccati_backward(cost, dyn)

    np.testing.assert_allclose(np.asarray(ctl_p.K), np.asarray(ctl_s.K),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ctl_p.kff), np.asarray(ctl_s.kff),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(val_p.V), np.asarray(val_s.V),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(val_p.v), np.asarray(val_s.v),
                               rtol=1e-7, atol=1e-8)


def test_parallel_ilqr_equals_sequential_at_zero_lambda():
    rng = np.random.default_rng(200)
    T = 101
    p = random_quadratic_problem(rng, T, dx=4, du=2)
    cost, _ = _pack(p)
    A, B = jnp.asarray(p["A"]), jnp.asarray(p["B"])

    ctl_s, val_s, _, dV_s, div = ilqr_backward(cost, A, B, 0.0, 1)
    assert not bool(div)
    ctl_p, val_p, dV_p = pilqr_backward(cost, A, B)

    np.testing.assert_allclose(np.asarray(ctl_p.K), np.asarray(ctl_s.K),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ctl_p.kff), np.asarray(ctl_s.kff),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(val_p.V), np.asarray(val_s.V),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(dV_p), np.asarray(dV_s), rtol=1e-7)


def test_parallel_riccati_long_horizon_stable():
    """Horizon-1000 stability of the compose algebra (SURVEY.md §7 hard parts)."""
    rng = np.random.default_rng(300)
    T = 1000
    p = random_quadratic_problem(rng, T, dx=2, du=1)
    # stabilize the random system so the value stays bounded at T = 1000
    p["A"] = 0.95 * p["A"]
    cost, dyn = _pack(p)

    ctl_s, val_s = riccati_backward(cost, dyn)
    ctl_p, val_p = priccati_backward(cost, dyn)

    np.testing.assert_allclose(np.asarray(ctl_p.K), np.asarray(ctl_s.K),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(val_p.V), np.asarray(val_s.V),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("T", [63, 160])
def test_sharded_backward_matches_single_device(T):
    """Multi-chip consistency (SURVEY.md §4 item 4): the horizon-block-sharded
    backward pass on the 8-device CPU mesh must reproduce the single-device result."""
    from jax.sharding import Mesh

    devices = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devices, axis_names=("time",))

    rng = np.random.default_rng(400 + T)
    p = random_quadratic_problem(rng, T, dx=3, du=2)
    cost, dyn = _pack(p)

    ctl_s, val_s = riccati_backward(cost, dyn)
    ctl_p, val_p = sharded_backward(cost, dyn, mesh, axis_name="time")

    np.testing.assert_allclose(np.asarray(ctl_p.K), np.asarray(ctl_s.K),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ctl_p.kff), np.asarray(ctl_s.kff),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(val_p.V), np.asarray(val_s.V),
                               rtol=1e-7, atol=1e-8)


def test_lane_major_assoc_scan_matches():
    """The lane-major (entry-plane) associative scan must agree with the
    cube-layout scan to machine precision — same composition, different layout
    and a pivot-free Gauss-Jordan in place of the LU solve."""
    import jax

    from trajopt_jax.core.pscan_lqr import pilqr_backward, pilqr_backward_lanes

    T, dx, du = 57, 4, 2
    ks = jax.random.split(jax.random.PRNGKey(0), 8)

    def spd(k, d, n):
        M = jax.random.normal(k, (n, d, d))
        return jnp.einsum("nij,nkj->nik", M, M) + d * jnp.eye(d)

    cost = QuadraticCost(
        Cxx=spd(ks[0], dx, T + 1),
        cx=jax.random.normal(ks[1], (T + 1, dx)),
        Cuu=spd(ks[2], du, T + 1),
        cu=jax.random.normal(ks[3], (T + 1, du)),
        Cxu=0.1 * jax.random.normal(ks[4], (T + 1, dx, du)),
        c0=jnp.zeros(T + 1),
    )
    A = 0.95 * (jnp.eye(dx) + 0.05 * jax.random.normal(ks[5], (T, dx, dx)))
    B = 0.1 * jax.random.normal(ks[6], (T, dx, du))

    p1, v1, dv1 = jax.jit(pilqr_backward)(cost, A, B)
    p2, v2, dv2 = jax.jit(pilqr_backward_lanes)(cost, A, B)
    np.testing.assert_allclose(np.asarray(p1.K), np.asarray(p2.K),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v1.V), np.asarray(v2.V),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(dv1), np.asarray(dv2),
                               rtol=1e-10, atol=1e-12)


def test_sharded_ilqr_backward_matches_lane_major():
    """The horizon-sharded delta-convention backward (ppermute ladder) must equal
    its single-device lane-major reference at λ = 0 AND λ > 0 (λ-folded
    semantics), and the λ-folded pass must equal the sequential recursion on the
    λ-augmented problem."""
    from jax.sharding import Mesh

    from trajopt_jax.core.pscan_lqr import (
        pilqr_backward_reg,
        sharded_ilqr_backward,
    )

    devices = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devices, axis_names=("time",))

    rng = np.random.default_rng(500)
    T, dx, du = 91, 4, 2
    p = random_quadratic_problem(rng, T, dx=dx, du=du)
    cost, _ = _pack(p)
    A, B = jnp.asarray(p["A"]), jnp.asarray(p["B"])

    for lmbda in (0.0, 0.7):
        ctl_l, val_l, dV_l, div_l = pilqr_backward_reg(cost, A, B, lmbda)
        ctl_s, val_s, dV_s, div_s = sharded_ilqr_backward(
            cost, A, B, mesh, "time", lmbda
        )
        assert not bool(div_l) and not bool(div_s)
        np.testing.assert_allclose(np.asarray(ctl_s.K), np.asarray(ctl_l.K),
                                   rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(np.asarray(ctl_s.kff), np.asarray(ctl_l.kff),
                                   rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(np.asarray(dV_s), np.asarray(dV_l), rtol=1e-7)

        # λ-folded == sequential recursion on the λ-augmented problem
        folded = cost._replace(Cuu=cost.Cuu + lmbda * jnp.eye(du))
        ctl_q, _, _, dV_q, div_q = ilqr_backward(folded, A, B, 0.0, 1)
        assert not bool(div_q)
        np.testing.assert_allclose(np.asarray(ctl_s.K), np.asarray(ctl_q.K),
                                   rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(np.asarray(ctl_s.kff), np.asarray(ctl_q.kff),
                                   rtol=1e-7, atol=1e-8)


def test_riccati_solver_time_mesh_matches():
    """Public-API horizon sharding: Riccati(mesh=…) == Riccati() on LQR."""
    from jax.sharding import Mesh

    import trajopt_jax
    from trajopt_jax.solvers import Riccati

    devices = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devices, axis_names=("time",))

    env = trajopt_jax.make("LQR-TO-v0")
    c_seq = Riccati(env, nb_steps=60, init_state=env.init()).run()
    c_shd = Riccati(env, nb_steps=60, init_state=env.init(), mesh=mesh).run()
    np.testing.assert_allclose(c_shd, c_seq, rtol=1e-8)


def test_ilqr_solver_time_mesh_matches_pscan():
    """Public-API horizon sharding for iLQR: make_ilqr_solver(time_mesh=…) must
    equal the single-device ``backward='pscan'`` engine (identical λ-folded
    semantics, different distribution) through the full solve."""
    from jax.sharding import Mesh

    import trajopt_jax
    from trajopt_jax.parallel.mpc import make_ilqr_solver

    devices = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devices, axis_names=("time",))

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    x0 = jnp.asarray(np.array(env.x0))

    s_ps = make_ilqr_solver(env, nb_steps=24, nb_iter=3, backward="pscan")
    s_sh = make_ilqr_solver(env, nb_steps=24, nb_iter=3, time_mesh=mesh)
    st_ps, _ = jax.jit(s_ps)(x0)
    st_sh, _ = jax.jit(s_sh)(x0)

    np.testing.assert_allclose(np.asarray(st_sh.last_return),
                               np.asarray(st_ps.last_return), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(st_sh.uref), np.asarray(st_ps.uref),
                               rtol=1e-6, atol=1e-8)


def test_ilqr_solver_2d_dp_time_mesh():
    """The full 2-D mesh story (VERDICT r1 #4): a ('dp', 'time') mesh with the
    MPC/problem batch sharded over 'dp' while each solve's horizon is
    block-sharded over 'time' (ppermute-ladder halos) — results equal the
    single-device pscan engine."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import trajopt_jax
    from trajopt_jax.parallel.mpc import make_ilqr_solver

    devices = np.array(jax.devices("cpu")[:8]).reshape(2, 4)
    mesh = Mesh(devices, axis_names=("dp", "time"))

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    x0 = jnp.asarray(np.array(env.x0))
    x0s = x0[None] + 0.05 * jnp.asarray([[0.0, 0.0], [1.0, -1.0], [-1.0, 0.5],
                                         [0.5, 0.5]])
    x0s = jax.device_put(x0s, NamedSharding(mesh, P("dp")))

    solve_t = make_ilqr_solver(env, nb_steps=24, nb_iter=3, time_mesh=mesh)
    st_2d, _ = jax.jit(jax.vmap(lambda x: solve_t(x)))(x0s)

    solve_ref = make_ilqr_solver(env, nb_steps=24, nb_iter=3, backward="pscan")
    st_ref, _ = jax.jit(jax.vmap(lambda x: solve_ref(x)))(
        jax.device_put(x0s, jax.devices("cpu")[0])
    )

    np.testing.assert_allclose(np.asarray(st_2d.last_return),
                               np.asarray(st_ref.last_return), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(st_2d.uref), np.asarray(st_ref.uref),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("T", [63, 160])
def test_sharded_gps_backward_matches_sequential(T):
    """Horizon sharding for the GPS soft-Riccati (VERDICT r4 item 7): the
    8-device ppermute-ladder pass must reproduce core/scan_lqr.gps_backward
    (reference gps/src/util.cpp:272-374) — policy, value (incl. the entropy
    v0 chain), Q-value, and the divergence flag."""
    from jax.sharding import Mesh

    from trajopt_jax.core.pscan_lqr import sharded_gps_backward
    from trajopt_jax.core.scan_lqr import gps_backward
    from trajopt_jax.core.types import LinearGaussianDynamics

    devices = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devices, axis_names=("time",))

    rng = np.random.default_rng(700 + T)
    p = random_quadratic_problem(rng, T, dx=3, du=2)
    cost, dyn_d = _pack(p)
    sig_half = rng.standard_normal((T, 3, 3))
    sigma = 0.1 * np.einsum("tij,tkj->tik", sig_half, sig_half) + np.eye(3)
    dyn = LinearGaussianDynamics(
        A=dyn_d.A, B=dyn_d.B, c=dyn_d.c, sigma=jnp.asarray(sigma)
    )
    alpha = jnp.asarray(np.exp(rng.uniform(-1.0, 2.0, size=T)))

    ctl_s, val_s, qval_s, div_s = gps_backward(cost, dyn, alpha)
    ctl_p, val_p, qval_p, div_p = sharded_gps_backward(
        cost, dyn, alpha, mesh, axis_name="time"
    )

    assert bool(div_p) == bool(div_s) == False  # noqa: E712
    np.testing.assert_allclose(np.asarray(ctl_p.K), np.asarray(ctl_s.K),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(ctl_p.kff), np.asarray(ctl_s.kff),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(ctl_p.sigma),
                               np.asarray(ctl_s.sigma),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(val_p.V), np.asarray(val_s.V),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(val_p.v), np.asarray(val_s.v),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(val_p.v0), np.asarray(val_s.v0),
                               rtol=1e-6, atol=1e-6)
    for name in ("Qxx", "Quu", "Qux", "qx", "qu", "q0"):
        np.testing.assert_allclose(
            np.asarray(getattr(qval_p, name)),
            np.asarray(getattr(qval_s, name)),
            rtol=1e-6, atol=1e-6, err_msg=name,
        )


def test_mbgps_solver_time_mesh_matches():
    """Public-API horizon sharding for GPS: make_mbgps_solver(time_mesh=…)
    must reproduce the unsharded solve through the full dual loop."""
    from jax.sharding import Mesh

    import trajopt_jax
    from trajopt_jax.parallel.gps import make_mbgps_solver

    devices = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devices, axis_names=("time",))

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05, sigma_scale=1e-4)
    mu0 = jnp.asarray(np.array(env.x0))
    sigma0 = 0.01 * jnp.eye(env.dm_state, dtype=mu0.dtype)
    key = jax.random.PRNGKey(0)

    s_ref = make_mbgps_solver(env, nb_steps=24, nb_iter=3, kl_bound=2.0)
    s_shd = make_mbgps_solver(env, nb_steps=24, nb_iter=3, kl_bound=2.0,
                              time_mesh=mesh)
    st_r, tr_r = jax.jit(s_ref)(key, mu0, sigma0)
    st_s, tr_s = jax.jit(s_shd)(key, mu0, sigma0)

    np.testing.assert_allclose(np.asarray(tr_s), np.asarray(tr_r),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(st_s.ctl.K), np.asarray(st_r.ctl.K),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st_s.ctl.kff),
                               np.asarray(st_r.ctl.kff),
                               rtol=1e-5, atol=1e-6)


def _lightdark_belief_expansion(T, seed=0):
    import trajopt_jax
    from trajopt_jax.core.belief import (
        belief_cost_expansion,
        belief_dynamics_expansion,
    )

    env = trajopt_jax.make("LightDark-TO-v0")
    key = jax.random.PRNGKey(seed)
    b, a = env.belief_dim, env.act_dim
    mu_b = 2.0 + 0.5 * jax.random.normal(key, (T + 1, b))
    sigma_b = jnp.tile(0.5 * jnp.eye(b), (T + 1, 1, 1))
    us = 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 1), (T, a))
    dyn = belief_dynamics_expansion(env, mu_b[:T], sigma_b[:T], us)
    cost = belief_cost_expansion(env, mu_b, sigma_b, us)
    return env, cost, dyn


@pytest.mark.parametrize("T", [12, 40])
def test_pbsp_backward_matches_sequential_lam0(T):
    """Parallel-in-time BSP backward (two-ladder decomposition): at λ = 0 it
    must reproduce core/belief.bsp_backward (bspilqr/src/util.cpp:83-204)
    exactly — gains, (S, s, τ) value triplet, dS, and the divergence flag."""
    from trajopt_jax.core.belief import bsp_backward
    from trajopt_jax.core.pscan_lqr import pbsp_backward

    _, cost, dyn = _lightdark_belief_expansion(T)
    ctl_s, S_s, s_s, tau_s, dS_s, div_s = bsp_backward(cost, dyn, 0.0, 1)
    ctl_p, S_p, s_p, tau_p, dS_p, div_p = pbsp_backward(cost, dyn, 0.0)

    assert bool(div_s) == bool(div_p) == False  # noqa: E712
    np.testing.assert_allclose(np.asarray(ctl_p.K), np.asarray(ctl_s.K),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ctl_p.kff), np.asarray(ctl_s.kff),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(S_p), np.asarray(S_s),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_s),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(tau_p), np.asarray(tau_s),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(dS_p), np.asarray(dS_s), rtol=1e-9)


@pytest.mark.parametrize("T", [12, 31])
def test_sharded_bsp_backward_matches_single_device(T):
    """The 8-device horizon-sharded BSP pass (both ppermute ladders crossing
    device blocks) must reproduce the single-device parallel pass exactly, at a
    nonzero λ (λ-folded semantics on both sides)."""
    from jax.sharding import Mesh

    from trajopt_jax.core.pscan_lqr import pbsp_backward, sharded_bsp_backward

    _, cost, dyn = _lightdark_belief_expansion(T, seed=2)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("time",))
    lam = 0.7

    out_1 = pbsp_backward(cost, dyn, lam)
    out_8 = jax.jit(
        lambda c, d: sharded_bsp_backward(c, d, lam, mesh, "time")
    )(cost, dyn)

    assert bool(out_1[5]) == bool(out_8[5]) == False  # noqa: E712
    np.testing.assert_allclose(np.asarray(out_8[0].K), np.asarray(out_1[0].K),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out_8[0].kff),
                               np.asarray(out_1[0].kff),
                               rtol=1e-9, atol=1e-12)
    for i, name in [(1, "S"), (2, "s"), (3, "tau"), (4, "dS")]:
        np.testing.assert_allclose(np.asarray(out_8[i]), np.asarray(out_1[i]),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_bsp_solver_time_mesh_matches():
    """Public-API horizon sharding for the belief-space family:
    make_bsp_solver(time_mesh=…) must reproduce the single-device λ-folded
    engine (backward='pscan') through the full λ/α outer loop, and land near
    the reference scan engine's solution on a benign solve."""
    from jax.sharding import Mesh

    import trajopt_jax
    from trajopt_jax.parallel.bsp import make_bsp_solver

    env = trajopt_jax.make("LightDark-TO-v0")
    mu0, sigma0 = env.init()
    mu0, sigma0 = jnp.asarray(mu0), jnp.asarray(sigma0)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("time",))

    s_loc = jax.jit(make_bsp_solver(env, nb_steps=10, nb_iter=25,
                                    backward="pscan"))
    s_shd = jax.jit(make_bsp_solver(env, nb_steps=10, nb_iter=25,
                                    time_mesh=mesh))
    st_l, tr_l = s_loc(mu0, sigma0)
    st_s, tr_s = s_shd(mu0, sigma0)

    np.testing.assert_allclose(np.asarray(tr_s), np.asarray(tr_l),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(st_s.uref), np.asarray(st_l.uref),
                               rtol=1e-8, atol=1e-10)

    # and the λ-folded engine solves the problem at least as well as the scan
    # engine (the iteration paths legitimately differ while λ > 0 — proximal
    # variant — and on this nonconvex solve the folded path lands ~0.2% LOWER,
    # so converged-objective equality is not the right assertion)
    s_ref = jax.jit(make_bsp_solver(env, nb_steps=10, nb_iter=25))
    st_r, tr_r = s_ref(mu0, sigma0)
    assert float(tr_s[-1]) <= float(tr_r[-1]) * (1.0 + 1e-3)
