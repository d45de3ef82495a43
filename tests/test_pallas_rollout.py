"""Parity tests for the Pallas rollout / line-search kernels
(core/pallas_rollout.py) against the lax.scan rollout (solvers/common.
rollout_tracking) — interpreter mode on CPU, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.core.pallas_rollout import (
    pack_rollout,
    pallas_rollout_returns,
    pallas_rollout_selected,
)
from trajopt_jax.core.types import LinearPolicy
from trajopt_jax.solvers.common import make_weighting, rollout_tracking
from test_env_tiles import TILE_ENVS


def _scan_forward_all(env, K, kff, xref, uref, weighting, alphas):
    def one(K1, kff1, xr, ur):
        ctl = LinearPolicy(K=K1, kff=kff1)
        return jax.vmap(
            lambda a: rollout_tracking(env, ctl, a, xr[0], xr, ur, weighting)
        )(jnp.asarray(alphas))

    return jax.vmap(one)(K, kff, xref, uref)


def _random_problem(env, key, N, T, scale=0.3):
    dx, du = env.dm_state, env.dm_act
    ks = jax.random.split(key, 5)
    K = scale * jax.random.normal(ks[0], (N, T, du, dx))
    kff = scale * jax.random.normal(ks[1], (N, T, du))
    uref = scale * jax.random.normal(ks[2], (N, T, du))
    x0 = jnp.asarray(env.x0) + 0.1 * jax.random.normal(ks[3], (N, dx))
    # a plausible reference trajectory: roll the env under uref from x0
    def roll(x0_, u_):
        def step(x, u):
            xn = env.dynamics(x, u)
            return xn, x
        xT, xs = jax.lax.scan(step, x0_, u_)
        return jnp.concatenate([xs, xT[None]], axis=0)
    xref = jax.vmap(roll)(x0, uref)
    return K, kff, xref, uref


@pytest.mark.parametrize("name", sorted(set(TILE_ENVS) | {"Pendulum-TO-v1"}))
def test_rollout_kernels_match_scan(name):
    """Phase A (all-α returns and finite flags) and phase B (one α per
    instance, trajectories emitted) against the scan rollouts, for every
    tile-protocol env."""
    env = trajopt_jax.make(name)
    N, T = 3, 8
    alphas = (1.0, 0.5, 0.1)
    weighting = make_weighting(T, None)
    K, kff, xref, uref = _random_problem(env, jax.random.PRNGKey(0), N, T)

    s_scan, a_scan, c_scan = _scan_forward_all(
        env, K, kff, xref, uref, weighting, alphas
    )
    ret_scan = jnp.sum(c_scan, axis=2)

    packed = pack_rollout(K, kff, xref, uref)
    ret_p, ok_p = pallas_rollout_returns(
        env, packed, weighting, alphas, interpret=True
    )
    np.testing.assert_allclose(np.asarray(ret_p[:N]), np.asarray(ret_scan),
                               rtol=1e-10)
    finite_scan = jnp.all(s_scan < 1e8, axis=(2, 3))
    np.testing.assert_array_equal(np.asarray(ok_p[:N]), np.asarray(finite_scan))

    pick = jnp.arange(N) % len(alphas)
    s_p, a_p, r_p = pallas_rollout_selected(
        env, packed, weighting, jnp.asarray(alphas)[pick], interpret=True
    )
    rows = jnp.arange(N)
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_scan[rows, pick]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_scan[rows, pick]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(r_p), np.asarray(ret_scan[rows, pick]),
                               rtol=1e-10)


def test_selected_alpha_per_lane():
    """Phase B with DIFFERENT α per lane must equal per-instance scan rollouts."""
    env = trajopt_jax.make("Cartpole-TO-v0")
    N, T = 4, 8
    weighting = make_weighting(T, None)
    K, kff, xref, uref = _random_problem(env, jax.random.PRNGKey(1), N, T)
    alphas = jnp.asarray([1.0, 0.31, 0.1, 0.031])

    packed = pack_rollout(K, kff, xref, uref)
    states, actions, rets = pallas_rollout_selected(
        env, packed, weighting, alphas, interpret=True
    )

    for i in range(N):
        ctl = LinearPolicy(K=K[i], kff=kff[i])
        s, a, c = rollout_tracking(
            env, ctl, alphas[i], xref[i, 0], xref[i], uref[i], weighting
        )
        np.testing.assert_allclose(np.asarray(states[i]), np.asarray(s),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(actions[i]), np.asarray(a),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(rets[i]), float(jnp.sum(c)),
                                   rtol=1e-10)


def test_solver_level_pallas_rollout_matches_scan_interpreted():
    """The FULL batched solver with rollout='pallas' (interpreter mode) vs the
    scan solver — covers the solver-level glue the kernel tests can't: the
    packed-gain handoff, first-acceptable-α selection, accept/reject masking,
    λ updates)."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_jax.make("Cartpole-TO-v0")
    N, T, nb_iter = 3, 12, 3
    x0 = jnp.asarray(np.asarray(env.x0))
    x0s = jnp.tile(x0, (N, 1)) + 0.01 * jnp.arange(N, dtype=x0.dtype)[:, None]

    ss = jax.jit(make_ilqr_solver_batched(env, T, nb_iter=nb_iter,
                                          backward="scan"))
    s_ref, tr_ref = ss(x0s)
    # the repack path: gains come batch-leading from the scan backward
    sp = make_ilqr_solver_batched(
        env, T, nb_iter=nb_iter, backward="scan", rollout="pallas",
        interpret=True,
    )
    s_p, tr_p = sp(x0s)

    np.testing.assert_allclose(np.asarray(tr_p), np.asarray(tr_ref), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(s_p.uref), np.asarray(s_ref.uref), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(s_p.xref), np.asarray(s_ref.xref), rtol=1e-8, atol=1e-10
    )


def test_slew_rate_and_activation():
    """Slew-rate control cost and sigmoid activation weighting run through the
    kernel cost path (mbgps.py:76-86 weighting; pendulum.py:111-125 slew)."""
    env = trajopt_jax.make("Pendulum-TO-v0", slew_rate=True)
    N, T = 2, 10
    weighting = make_weighting(T, {"mult": 0.5, "shift": 5.0})
    K, kff, xref, uref = _random_problem(env, jax.random.PRNGKey(2), N, T)
    alphas = (1.0, 0.1)

    s_scan, a_scan, c_scan = _scan_forward_all(
        env, K, kff, xref, uref, weighting, alphas
    )
    ret_p, _ = pallas_rollout_returns(
        env, pack_rollout(K, kff, xref, uref), weighting, alphas, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(ret_p[:N]), np.asarray(jnp.sum(c_scan, axis=2)), rtol=1e-10
    )


def test_solver_fast_line_search_pallas_matches_scan():
    """fast_line_search=True with rollout='pallas' (the 1-candidate
    phase-A + cond fallback) must reproduce the plain scan solver — including
    iterations where some instance rejects alpha_0 (the slow branch)."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    N, T = 4, 16
    x0 = jnp.asarray(np.asarray(env.x0), jnp.float64)
    x0s = jnp.tile(x0, (N, 1)) + 0.3 * jnp.arange(N, dtype=jnp.float64)[:, None]

    ss = jax.jit(make_ilqr_solver_batched(env, T, nb_iter=4, backward="scan"))
    rs = np.asarray(ss(x0s)[0].last_return)
    sf = make_ilqr_solver_batched(
        env, T, nb_iter=4, backward="scan", rollout="pallas",
        fast_line_search=True, interpret=True,
    )
    rf = np.asarray(sf(x0s)[0].last_return)
    np.testing.assert_allclose(rf, rs, rtol=1e-8)


@pytest.mark.parametrize("name", ["Cartpole-TO-v0", "Pendulum-TO-v0"])
def test_solver_pallas_engines_match_scan_interpreted(name):
    """Both kernels in the solver (interpreter mode): the batch-minor gains of
    the backward kernel feed the rollout kernels directly, inside the λ
    while_loop — results must match the scan engines."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_jax.make(name)
    N, T, nb_iter = 3, 8, 2
    x0 = jnp.asarray(np.asarray(env.x0))
    x0s = jnp.tile(x0, (N, 1)) + 0.01 * jnp.arange(N, dtype=x0.dtype)[:, None]

    s_ref, tr_ref = jax.jit(
        make_ilqr_solver_batched(env, T, nb_iter=nb_iter, backward="scan")
    )(x0s)
    s_p, tr_p = make_ilqr_solver_batched(
        env, T, nb_iter=nb_iter, backward="pallas", rollout="pallas",
        interpret=True,
    )(x0s)
    np.testing.assert_allclose(np.asarray(tr_p), np.asarray(tr_ref), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(s_p.uref), np.asarray(s_ref.uref), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(s_p.K), np.asarray(s_ref.K), rtol=1e-8, atol=1e-10
    )


def test_rollout_lowers_to_triton():
    """Both rollout phases lower to Triton IR for the GPU at the main path's
    candidate count (11 α, padded to 16)."""
    from trajopt_jax.core.pallas_rollout import pallas_rollout_returns

    env = trajopt_jax.make("Cartpole-TO-v0")
    N, T = 40, 6
    with jax.enable_x64(False):
        K, kff, xref, uref = jax.tree.map(
            lambda x: x.astype(jnp.float32),
            _random_problem(env, jax.random.PRNGKey(0), N, T),
        )
        w = make_weighting(T, None).astype(jnp.float32)

        def both(K, kff, xref, uref):
            pk = pack_rollout(K, kff, xref, uref)
            ret, ok = pallas_rollout_returns(
                env, pk, w, tuple(np.geomspace(1.0, 1e-3, 11))
            )
            return ret, ok, pallas_rollout_selected(env, pk, w, ret[:N, 0])

        lowered = jax.jit(both).trace(K, kff, xref, uref).lower(
            lowering_platforms=("cuda",)
        )
    assert lowered.as_text().count("xla.gpu.triton") == 2
