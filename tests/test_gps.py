import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.solvers.gps import MBGPS, MFGPS
from trajopt_jax.solvers.riccati import Riccati


def test_mbgps_matches_riccati_on_lqr():
    """The reference's own cross-solver oracle (examples/gps/analytical/topt/
    mbgps_riccati.py:20-41): MBGPS and Riccati on the same LQR task must converge to
    the same cost."""
    env = trajopt_jax.make("LQR-TO-v0")

    mbgps = MBGPS(
        env, nb_steps=100, init_state=env.init(), init_action_sigma=100.0,
        kl_bound=5.0,
    )
    trace = mbgps.run(nb_iter=15)

    riccati = Riccati(env, nb_steps=100, init_state=env.init())
    c_riccati = riccati.run()
    c_riccati = riccati.run()  # idempotent second sweep = exact optimum

    assert np.isfinite(trace[-1])
    # final mean-trajectory cost within 2% of the exact LQR optimum
    np.testing.assert_allclose(trace[-1], c_riccati, rtol=2e-2)

    # feedback gains approach the exact LQR gains away from the horizon tail
    # (the KL-constrained policy at finite alpha is a *soft* optimum, so gains carry
    # an entropy bias — the reference's own oracle compares costs, not gains)
    K_gps = np.asarray(mbgps.ctl.K)[:50]
    K_ric = np.asarray(riccati.ctl.K)[:50]
    np.testing.assert_allclose(K_gps, K_ric, rtol=0.15, atol=0.1)


def test_mbgps_pendulum_swingup():
    """Headline GPS task (examples/gps/analytical/topt/mb_pendulum.py:20-28):
    pendulum swing-up with sigmoid activation."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
    solver = MBGPS(
        env, nb_steps=100, init_state=env.init(), init_action_sigma=5.0,
        kl_bound=10.0, action_penalty=1.0, activation={"mult": 1.0, "shift": 80},
    )
    trace = solver.run(nb_iter=25)

    # every iteration must be accepted (KL bound met within 25% tolerance each time)
    assert len(trace) == 26
    assert np.isfinite(trace[-1])
    # monotone descent under the KL-trust region
    assert all(b <= a + 1e-9 for a, b in zip(trace[:-1], trace[1:]))
    # substantial progress toward the swing-up optimum (~71 for this cost, found by
    # iLQR on the identical objective; MBGPS approaches it at the KL-limited rate)
    assert trace[-1] < 0.6 * trace[0]
    # the pendulum must have moved well away from hanging (theta=pi) toward upright
    th = abs(float(solver.xdist.mu[-1, 0]))
    assert th < np.pi / 3


def test_mfgps_learns_lqr_dynamics():
    """MFGPS on the linear env: the per-timestep regression must recover dynamics
    close to the analytic (A, B, c) given enough rollouts."""
    env = trajopt_jax.make("LQR-TO-v1")
    solver = MFGPS(
        env, nb_steps=40, init_state=env.init(), init_action_sigma=1.0,
        kl_bound=2.0, prior={"K": 1e-6, "psi": 1e-8, "nu": 0.1},
    )
    data = solver.rollout(64)
    dyn = solver.learn_dynamics(data)

    A_true, B_true, c_true = env._ABc()
    np.testing.assert_allclose(np.asarray(dyn.A[5]), np.asarray(A_true), atol=5e-2)
    np.testing.assert_allclose(np.asarray(dyn.B[5]), np.asarray(B_true), atol=5e-2)
    np.testing.assert_allclose(np.asarray(dyn.c[5]), np.asarray(c_true), atol=5e-2)


def test_mfgps_improves_on_lqr():
    env = trajopt_jax.make("LQR-TO-v1")
    solver = MFGPS(
        env, nb_steps=40, init_state=env.init(), init_action_sigma=1.0,
        kl_bound=2.0,
    )
    trace = solver.run(nb_iter=8, nb_episodes=64)
    assert np.isfinite(trace[-1])
    assert trace[-1] < trace[0]
