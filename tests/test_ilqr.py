import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.core.scan_lqr import ilqr_backward
from trajopt_jax.core.types import QuadraticCost
from trajopt_jax.solvers.ilqr import iLQR
from trajopt_jax.solvers.riccati import Riccati

from ref_impl import ilqr_backward_np, random_quadratic_problem


@pytest.mark.parametrize("reg", [1, 2])
@pytest.mark.parametrize("lmbda", [0.0, 1.0, 37.5])
def test_ilqr_backward_matches_numpy_oracle(reg, lmbda):
    rng = np.random.default_rng(42)
    p = random_quadratic_problem(rng, T=29, dx=4, du=2)

    K_np, kff_np, V_np, v_np, dV_np, div_np = ilqr_backward_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"], lmbda, reg
    )
    assert not div_np

    cost = QuadraticCost(
        Cxx=jnp.asarray(p["Cxx"]), cx=jnp.asarray(p["cx"]),
        Cuu=jnp.asarray(p["Cuu"]), cu=jnp.asarray(p["cu"]),
        Cxu=jnp.asarray(p["Cxu"]), c0=jnp.asarray(p["c0"]),
    )
    ctl, value, qvalue, dV, diverged = ilqr_backward(
        cost, jnp.asarray(p["A"]), jnp.asarray(p["B"]), lmbda, reg
    )

    assert not bool(diverged)
    np.testing.assert_allclose(np.asarray(ctl.K), K_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ctl.kff), kff_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.V), V_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.v), v_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dV), dV_np, rtol=1e-9, atol=1e-9)


def test_ilqr_backward_detects_divergence():
    rng = np.random.default_rng(7)
    p = random_quadratic_problem(rng, T=10, dx=3, du=1)
    # make the action cost strongly negative -> Quu loses positive definiteness
    Cuu = p["Cuu"] - 1e3 * np.eye(1)
    cost = QuadraticCost(
        Cxx=jnp.asarray(p["Cxx"]), cx=jnp.asarray(p["cx"]),
        Cuu=jnp.asarray(Cuu), cu=jnp.asarray(p["cu"]),
        Cxu=jnp.asarray(p["Cxu"]), c0=jnp.asarray(p["c0"]),
    )
    *_, diverged = ilqr_backward(cost, jnp.asarray(p["A"]), jnp.asarray(p["B"]), 0.0, 1)
    assert bool(diverged)


def test_ilqr_matches_riccati_on_lqr():
    """On an exactly linear-quadratic task iLQR must find the LQR optimum."""
    env = trajopt_jax.make("LQR-TO-v0")

    riccati = Riccati(env, nb_steps=60, init_state=env.init())
    c_riccati = riccati.run()

    ilqr = iLQR(env, nb_steps=60, init_state=env.init()[0])
    trace = ilqr.run(nb_iter=50)

    assert trace[-1] <= trace[0]
    np.testing.assert_allclose(trace[-1], c_riccati, rtol=1e-3)


def test_ilqr_pendulum_swingup_converges():
    """Pendulum swing-up (nx=2, nu=1): the headline iLQR task
    (examples/ilqr/mpc/pendulum.py with dt=0.05, horizon 60)."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solver = iLQR(env, nb_steps=60, init_state=jnp.asarray(env.x0),
                  action_penalty=1e-5)
    trace = solver.run(nb_iter=25)

    assert np.isfinite(trace[-1])
    assert trace[-1] < trace[0]
    # the pendulum should be near upright (theta ~ 0 mod 2pi) at the end
    th_final = float(solver.xref[-1, 0])
    wrapped = (th_final + np.pi) % (2 * np.pi) - np.pi
    assert abs(wrapped) < 0.5
