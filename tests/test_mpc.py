import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.parallel.mpc import make_ilqr_solver, make_mpc_runner, run_mpc_batch
from trajopt_jax.solvers.ilqr import iLQR


def test_jit_ilqr_matches_host_loop_solver():
    """The fully-compiled iLQR must reach the same optimum as the host-loop class
    (same α-grid/λ semantics; only the tiny random kff init differs)."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))

    solve = jax.jit(make_ilqr_solver(env, nb_steps=60, nb_iter=25))
    state, trace = solve(jnp.asarray(env.x0))

    host = iLQR(env, nb_steps=60, init_state=jnp.asarray(env.x0))
    host_trace = host.run(nb_iter=25)

    assert np.isfinite(float(state.last_return))
    np.testing.assert_allclose(
        float(state.last_return), host_trace[-1], rtol=5e-2
    )
    # swing-up reached
    th = float(state.xref[-1, 0])
    assert abs((th + np.pi) % (2 * np.pi) - np.pi) < 0.5


def test_jit_ilqr_trace_monotone():
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    solve = jax.jit(make_ilqr_solver(env, nb_steps=40, nb_iter=15))
    state, trace = solve(jnp.asarray(env.x0))
    tr = np.asarray(trace)
    assert np.all(np.diff(tr) <= 1e-6)


def test_mpc_runner_controls_pendulum():
    """Compiled receding-horizon MPC (examples/ilqr/mpc/pendulum.py config scaled
    down: horizon 25, 40 control steps)."""
    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    run = jax.jit(make_mpc_runner(env, horizon=25, nb_steps=40, nb_iter=6))
    states, actions, costs = run(jax.random.PRNGKey(0), jnp.asarray(env.x0))

    assert states.shape == (41, 2)
    assert np.all(np.isfinite(np.asarray(states)))
    # pendulum driven toward upright by the end
    th_end = float(states[-1, 0])
    assert abs((th_end + np.pi) % (2 * np.pi) - np.pi) < 0.6


def test_mpc_batch_sharded_over_mesh():
    """Batched MPC with the episode axis sharded over the 8-device CPU mesh — the
    DP replacement for the reference's joblib farm
    (examples/ilqr/mpc/pendulum_parallel.py)."""
    from jax.sharding import Mesh

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))

    data = run_mpc_batch(
        env, jax.random.PRNGKey(1), nb_episodes=8, horizon=15, nb_steps=10,
        nb_iter=3, mesh=mesh,
    )
    assert data["x"].shape == (8, 11, 2)
    assert data["u"].shape == (8, 10, 1)
    assert np.all(np.isfinite(np.asarray(data["x"])))

    # sharded result identical to unsharded
    data2 = run_mpc_batch(
        env, jax.random.PRNGKey(1), nb_episodes=8, horizon=15, nb_steps=10,
        nb_iter=3, mesh=None,
    )
    np.testing.assert_allclose(np.asarray(data["x"]), np.asarray(data2["x"]),
                               rtol=1e-7, atol=1e-8)


def test_batched_solver_matches_vmapped():
    """The batch-native solver (one batched backward kernel + global masked λ loop)
    must reproduce the vmapped per-instance solver exactly."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    x0s = jnp.asarray(env.x0) + 0.3 * jax.random.normal(jax.random.PRNGKey(3), (5, 2))

    solve_one = make_ilqr_solver(env, nb_steps=30, nb_iter=8)
    ref_state, ref_trace = jax.jit(jax.vmap(lambda x: solve_one(x)))(x0s)

    solve_b = jax.jit(make_ilqr_solver_batched(env, nb_steps=30, nb_iter=8))
    state, trace = solve_b(x0s)

    np.testing.assert_allclose(
        np.asarray(state.last_return), np.asarray(ref_state.last_return),
        rtol=1e-9, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(state.uref), np.asarray(ref_state.uref), rtol=1e-7, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(trace), np.asarray(jnp.swapaxes(ref_trace, 0, 1)),
        rtol=1e-9, atol=1e-9,
    )


def test_batched_mpc_sharded_matches_vmapped():
    """Batch-native MPC under shard_map on the 8-device mesh == vmapped MPC."""
    from jax.sharding import Mesh

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))

    data = run_mpc_batch(
        env, jax.random.PRNGKey(1), nb_episodes=8, horizon=15, nb_steps=10,
        nb_iter=3, mesh=mesh, batched=True,
    )
    ref = run_mpc_batch(
        env, jax.random.PRNGKey(1), nb_episodes=8, horizon=15, nb_steps=10,
        nb_iter=3, mesh=None, batched=False,
    )
    np.testing.assert_allclose(np.asarray(data["x"]), np.asarray(ref["x"]),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(data["u"]), np.asarray(ref["u"]),
                               rtol=1e-7, atol=1e-8)
