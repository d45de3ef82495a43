"""Batched BSP-iLQR solver (parallel/bsp.make_bsp_solver_batched) parity:
per-instance traces must match the single-problem compiled solver exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.parallel.bsp import make_bsp_solver, make_bsp_solver_batched


def _problem(N):
    env = trajopt_jax.make("LightDark-TO-v0")
    mu0, sigma0 = env.init()
    mu0s = jnp.tile(jnp.asarray(mu0), (N, 1)) \
        + 0.05 * jnp.arange(N, dtype=jnp.float64)[:, None]
    sigma0s = jnp.tile(jnp.asarray(sigma0), (N, 1, 1))
    return env, mu0s, sigma0s


def test_bsp_batched_matches_single():
    N, T, nb_iter = 3, 10, 6
    env, mu0s, sigma0s = _problem(N)

    single = jax.jit(make_bsp_solver(env, nb_steps=T, nb_iter=nb_iter))
    traces_ref = []
    for i in range(N):
        _, tr = single(mu0s[i], sigma0s[i])
        traces_ref.append(np.asarray(tr))
    traces_ref = np.stack(traces_ref, axis=1)  # (nb_iter, N)

    solve = jax.jit(make_bsp_solver_batched(env, nb_steps=T, nb_iter=nb_iter))
    state, trace = solve(mu0s, sigma0s)
    np.testing.assert_allclose(np.asarray(trace), traces_ref, rtol=1e-8,
                               atol=1e-8)
    assert np.all(np.isfinite(np.asarray(state.last_return)))


def test_bsp_batched_sharded_matches_unsharded():
    """mesh= block-shards the problem axis; per-shard λ loops must reproduce
    the unsharded batched solver exactly (8-device virtual CPU mesh)."""
    from trajopt_jax.parallel.mesh import make_mesh

    N, T, nb_iter = 8, 8, 4
    env, mu0s, sigma0s = _problem(N)
    base = jax.jit(make_bsp_solver_batched(env, nb_steps=T, nb_iter=nb_iter,
                                           engine="scan"))
    mesh = make_mesh(("dp",))
    sharded = jax.jit(make_bsp_solver_batched(
        env, nb_steps=T, nb_iter=nb_iter, engine="scan", mesh=mesh
    ))
    _, tr_ref = base(mu0s, sigma0s)
    _, tr_sh = sharded(mu0s, sigma0s)
    np.testing.assert_allclose(np.asarray(tr_sh), np.asarray(tr_ref),
                               rtol=1e-9, atol=1e-9)
