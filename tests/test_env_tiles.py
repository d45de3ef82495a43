"""Tile-protocol parity for the round-4 env extensions (VERDICT r3 item 5):
Robot (backward-RK4 integration + dt-scaled cost twin), DoubleCartpole
(closed-form 3×3 manipulator solve), and the n-link chains (Lagrangian-path
``_ode_parts`` with jvp columns + unrolled Gauss–Jordan mass solve)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.core.pallas_rollout import tile_cost, tile_dynamics

TILE_ENVS = [
    "Pendulum-TO-v0",
    "Cartpole-TO-v0",
    "Robot-TO-v0",
    "DoubleCartpole-TO-v0",
    "DoubleCartpole-TO-v1",
    "DoublePendulum-TO-v0",
    "DoublePendulum-TO-v1",
    "QuadPendulum-TO-v0",
    "QuadPendulum-TO-v1",
]


@pytest.mark.parametrize("name", TILE_ENVS)
def test_tile_dynamics_matches_env_dynamics(name):
    env = trajopt_jax.make(name)
    assert env.supports_tiles
    rng = np.random.default_rng(0)
    for i in range(5):
        x = jnp.asarray(0.5 * rng.standard_normal(env.dm_state))
        u = jnp.asarray(0.5 * rng.standard_normal(env.dm_act))
        want = env.dynamics(x, u)
        got = jnp.stack(
            tile_dynamics(env, [x[i] for i in range(env.dm_state)],
                          [u[j] for j in range(env.dm_act)])
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-11
        )


@pytest.mark.parametrize("name", TILE_ENVS)
def test_tile_cost_matches_env_cost(name):
    env = trajopt_jax.make(name)
    rng = np.random.default_rng(1)
    for w in (1.0, 0.0, 3.5):
        x = jnp.asarray(0.5 * rng.standard_normal(env.dm_state))
        u = jnp.asarray(0.5 * rng.standard_normal(env.dm_act))
        want = env.cost(x, u, jnp.zeros(env.dm_act, x.dtype), w)
        got = tile_cost(
            env, [x[i] for i in range(env.dm_state)],
            [u[j] for j in range(env.dm_act)],
            [jnp.zeros((), x.dtype)] * env.dm_act, w,
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-11
        )


def test_nlink_ode_parts_matches_array_ode():
    for name in ("DoublePendulum-TO-v0", "QuadPendulum-TO-v0"):
        env = trajopt_jax.make(name)
        rng = np.random.default_rng(2)
        for _ in range(5):
            x = jnp.asarray(rng.standard_normal(env.dm_state))
            u = jnp.asarray(rng.standard_normal(env.dm_act))
            want = env._ode(x, u)
            got = jnp.stack(
                env._ode_parts([x[i] for i in range(env.dm_state)],
                               [u[j] for j in range(env.dm_act)])
            )
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(want), rtol=1e-8, atol=1e-10
            )


@pytest.mark.parametrize("name", ["Robot-TO-v0", "DoubleCartpole-TO-v0"])
def test_solver_glue_pallas_rollout_matches_scan(name):
    """Solver-level parity of rollout='pallas' (interpret) on the new tile
    envs — the fused line search must reproduce the scan line search."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_jax.make(name)
    N, T = 4, 16
    rng = np.random.default_rng(3)
    x0 = np.asarray(env.x0, dtype=np.float64)
    x0s = jnp.asarray(x0[None] + 0.01 * rng.standard_normal((N, env.dm_state)))

    ss = jax.jit(make_ilqr_solver_batched(env, T, nb_iter=3, backward="scan"))
    rs = np.asarray(ss(x0s)[0].last_return)
    sp = make_ilqr_solver_batched(
        env, T, nb_iter=3, backward="scan", rollout="pallas", interpret=True
    )
    rp = np.asarray(sp(x0s)[0].last_return)
    np.testing.assert_allclose(rp, rs, rtol=1e-7)
