"""Positive-definiteness detection and small SPD helpers.

The reference detects SPD failure with Armadillo's ``is_sympd`` / try-catch around
``inv_sympd`` (ilqr/src/util.cpp:145, rgps/src/util.cpp:735-740).  Under ``jit`` we
cannot raise, so failure is derived from the Cholesky factor: ``jnp.linalg.cholesky``
yields NaNs for non-PD inputs, which we reduce to a boolean ``diverge`` flag that the
solvers branch on (matching the reference's λ-escalation / bail-out logic).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def cholesky_ok(M: Array) -> Array:
    """True iff M (symmetric) is positive definite, per its Cholesky factor."""
    chol = jnp.linalg.cholesky(M)
    return jnp.all(jnp.isfinite(chol))


def solve_psd(M: Array, b: Array) -> Array:
    """Solve M x = b for symmetric positive-definite M via Cholesky.

    All kernel inversions go through Cholesky rather than LU: the PD structure is
    guaranteed at every site (Quu after regularization, −Quu for the soft-KL pass,
    covariances), and Cholesky is the cheaper factorization.
    """
    return chol_solve(jnp.linalg.cholesky(M), b)


def chol_solve(chol: Array, b: Array) -> Array:
    """Solve (L Lᵀ) x = b given the lower Cholesky factor L."""
    import jax.scipy.linalg as jsl

    y = jsl.solve_triangular(chol, b, lower=True)
    return jsl.solve_triangular(chol.T, y, lower=False)


def inv_psd(M: Array) -> Array:
    """Inverse of a symmetric positive-definite matrix (Armadillo ``inv_sympd``)."""
    return chol_solve(jnp.linalg.cholesky(M), jnp.eye(M.shape[-1], dtype=M.dtype))


def logdet_psd(M: Array) -> Array:
    """log det of an SPD matrix via Cholesky."""
    chol = jnp.linalg.cholesky(M)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
