"""Parity and solver tests for the square-root (S, s, τ) belief-value backward
pass (core/belief.bsp_backward_sqrt) vs the dense recursion it replaces
(bspilqr/src/util.cpp:146-189 semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.core.belief import (
    belief_cost_expansion,
    belief_dynamics_expansion,
    bsp_backward,
    bsp_backward_sqrt,
)


def _lightdark_expansion(T=12, seed=0):
    env = trajopt_jax.make("LightDark-TO-v0")
    key = jax.random.PRNGKey(seed)
    b, a = env.belief_dim, env.act_dim
    mu_b = 2.0 + 0.5 * jax.random.normal(key, (T + 1, b))
    sigma_b = jnp.tile(0.5 * jnp.eye(b), (T + 1, 1, 1))
    us = 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 1), (T, a))
    dyn = belief_dynamics_expansion(env, mu_b[:T], sigma_b[:T], us)
    cost = belief_cost_expansion(env, mu_b, sigma_b, us)
    return cost, dyn


@pytest.mark.parametrize("reg,lmbda", [(1, 0.0), (1, 0.4), (2, 0.4)])
def test_sqrt_backward_matches_dense_f64(reg, lmbda):
    """In f64 (no jitters) the factor recursion must reproduce the dense
    recursion: same gains, same value triplet, same dS."""
    cost, dyn = _lightdark_expansion()
    ctl_d, S_d, s_d, tau_d, dS_d, div_d = bsp_backward(cost, dyn, lmbda, reg)
    ctl_q, S_q, s_q, tau_q, dS_q, div_q = bsp_backward_sqrt(cost, dyn, lmbda, reg)
    assert not bool(div_d) and not bool(div_q)
    np.testing.assert_allclose(np.asarray(ctl_q.K), np.asarray(ctl_d.K),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(ctl_q.kff), np.asarray(ctl_d.kff),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(S_q), np.asarray(S_d),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s_q), np.asarray(s_d),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(tau_q), np.asarray(tau_d),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dS_q), np.asarray(dS_d), rtol=1e-8)


def test_sqrt_backward_value_psd_by_construction():
    """S from the factor recursion is UᵀU — every eigenvalue must be ≥ 0 exactly
    (the dense recursion only promises symmetry)."""
    cost, dyn = _lightdark_expansion(T=20, seed=3)
    _, S, _, _, _, div = bsp_backward_sqrt(cost, dyn, 0.0, 1)
    assert not bool(div)
    w = np.linalg.eigvalsh(np.asarray(S))
    assert np.all(w >= -1e-12)


def test_sqrt_solver_matches_dense_solver():
    """Compiled BSP solver with value_form='sqrt' == 'dense' through the full
    solve (f64, light-dark)."""
    from trajopt_jax.parallel.bsp import make_bsp_solver

    env = trajopt_jax.make("LightDark-TO-v0")
    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(mu0)
    sigma0 = jnp.asarray(sigma0)

    s_d = jax.jit(make_bsp_solver(env, nb_steps=10, nb_iter=6))
    s_q = jax.jit(make_bsp_solver(env, nb_steps=10, nb_iter=6, value_form="sqrt"))
    st_d, _ = s_d(mu0, sigma0)
    st_q, _ = s_q(mu0, sigma0)
    np.testing.assert_allclose(np.asarray(st_q.last_return),
                               np.asarray(st_d.last_return), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(st_q.uref), np.asarray(st_d.uref),
                               rtol=1e-5, atol=1e-7)
