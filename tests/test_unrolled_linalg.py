"""Parity of the statically-unrolled small-matrix linalg vs jnp.linalg.

These primitives back every Cholesky/solve on the RGPS T-sequential scan paths
(core/cubature.py), so exact agreement with the LAPACK-style kernels is what
keeps the golden-pinned solver outputs stable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajopt_jax.core.unrolled_linalg import (
    chol_solve_unrolled,
    chol_unrolled,
    inv_psd_unrolled,
    logdet_from_chol,
    solve_tri_lower_unrolled,
    solve_tri_upper_from_lower_unrolled,
)


def _spd(rng, *shape):
    n = shape[-1]
    A = rng.standard_normal(shape + (n,))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 2, 5, 28])
def test_chol_matches_lapack(n):
    rng = np.random.default_rng(0)
    M = jnp.asarray(_spd(rng, 7, n))
    np.testing.assert_allclose(
        chol_unrolled(M), jnp.linalg.cholesky(M), rtol=1e-10, atol=1e-10
    )


@pytest.mark.parametrize("n,m", [(4, 1), (28, 28), (5, 3)])
def test_triangular_solves(n, m):
    rng = np.random.default_rng(1)
    L = np.asarray(jnp.linalg.cholesky(jnp.asarray(_spd(rng, 3, n))))
    B = rng.standard_normal((3, n, m))
    np.testing.assert_allclose(
        solve_tri_lower_unrolled(L, B), np.linalg.solve(L, B), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        solve_tri_upper_from_lower_unrolled(L, B),
        np.linalg.solve(np.swapaxes(L, -1, -2), B),
        rtol=1e-9,
        atol=1e-9,
    )


def test_chol_solve_and_inverse():
    rng = np.random.default_rng(2)
    M = _spd(rng, 28)
    L = chol_unrolled(jnp.asarray(M))
    b = rng.standard_normal(28)
    np.testing.assert_allclose(
        chol_solve_unrolled(L, jnp.asarray(b)), np.linalg.solve(M, b), rtol=1e-8
    )
    np.testing.assert_allclose(inv_psd_unrolled(jnp.asarray(M)), np.linalg.inv(M), rtol=1e-8)
    np.testing.assert_allclose(
        logdet_from_chol(L), np.linalg.slogdet(M)[1], rtol=1e-10
    )


def test_non_pd_yields_nan():
    M = jnp.asarray(np.diag([1.0, -1.0, 2.0]))
    L = chol_unrolled(M)
    assert not bool(jnp.all(jnp.isfinite(L)))


def test_jit_and_grad_clean():
    rng = np.random.default_rng(3)
    M = jnp.asarray(_spd(rng, 6))

    f = jax.jit(lambda A: jnp.sum(chol_unrolled(A)))
    g = jax.grad(f)(M)
    assert bool(jnp.all(jnp.isfinite(g)))
