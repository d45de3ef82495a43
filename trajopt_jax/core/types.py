"""Canonical pytree containers for the JAX trajectory-optimization stack.

One set of containers replaces the five near-duplicate ``objects.py`` zoos of the
reference (``trajopt/{riccati,ilqr,elqr,gps,rgps,bspilqr}/objects.py``).  All arrays are
**time-leading** — ``(T, n, m)`` — which is the natural layout for ``lax.scan`` over the
horizon and for sharding the horizon axis across devices.  (The reference keeps
Fortran-ordered trailing-time cubes ``(n, m, T)``, e.g. riccati/objects.py:10.)

These are plain ``NamedTuple``s: automatically registered pytrees, immutable, cheap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array


class LinearDynamics(NamedTuple):
    """Affine dynamics x' = A x + B u + c, stacked over the horizon.

    Mirrors the reference's ``LinearDynamics`` (riccati/objects.py:68) with the Taylor
    residual ``c``; the iLQR variant (ilqr/objects.py:81) simply carries ``c == 0``.
    """

    A: Array  # (T, dx, dx)
    B: Array  # (T, dx, du)
    c: Array  # (T, dx)

    @property
    def horizon(self) -> int:
        return self.A.shape[0]


class LinearGaussianDynamics(NamedTuple):
    """Affine dynamics with Gaussian process noise (gps/objects.py:133)."""

    A: Array      # (T, dx, dx)
    B: Array      # (T, dx, du)
    c: Array      # (T, dx)
    sigma: Array  # (T, dx, dx)

    @property
    def horizon(self) -> int:
        return self.A.shape[0]


class QuadraticCost(NamedTuple):
    """Stacked quadratic cost.

    Two conventions share this container (see reference survey §2.6):

    * **absolute** (riccati/gps/rgps, gps/objects.py:111-130): cost(x, u) =
      xᵀ Cxx x + uᵀ Cuu u + 2 xᵀ Cxu u + cxᵀ x + cuᵀ u + c0, with Cxx = ½·Hessian and
      gradients recentered to the origin.
    * **delta** (ilqr, ilqr/objects.py:68-78): raw Hessians/gradients about the
      reference point; c0 unused (zeros).
    """

    Cxx: Array  # (T, dx, dx)
    cx: Array   # (T, dx)
    Cuu: Array  # (T, du, du)
    cu: Array   # (T, du)
    Cxu: Array  # (T, dx, du)
    c0: Array   # (T,)

    @property
    def horizon(self) -> int:
        return self.Cxx.shape[0]


class QuadraticValue(NamedTuple):
    """Quadratic state-value function V(x) = xᵀ V x + vᵀ x + v0 (per convention)."""

    V: Array   # (T, dx, dx)
    v: Array   # (T, dx)
    v0: Array  # (T,)


class QuadraticQValue(NamedTuple):
    """Quadratic state-action value blocks (ilqr/objects.py:14, gps/objects.py:43)."""

    Qxx: Array  # (T, dx, dx)
    Quu: Array  # (T, du, du)
    Qux: Array  # (T, du, dx)
    qx: Array   # (T, dx)
    qu: Array   # (T, du)
    q0: Array   # (T,)


class LinearPolicy(NamedTuple):
    """Time-varying affine controller u = kff + K x (riccati/objects.py:111)."""

    K: Array    # (T, du, dx)
    kff: Array  # (T, du)

    @property
    def horizon(self) -> int:
        return self.K.shape[0]


class LinearGaussianPolicy(NamedTuple):
    """Time-varying linear-Gaussian controller u ~ N(kff + K x, sigma)
    (gps/objects.py:264)."""

    K: Array      # (T, du, dx)
    kff: Array    # (T, du)
    sigma: Array  # (T, du, du)

    @property
    def horizon(self) -> int:
        return self.K.shape[0]

    def mean(self, x: Array, t) -> Array:
        return self.K[t] @ x + self.kff[t]


class GaussianSequence(NamedTuple):
    """A sequence of Gaussian marginals (gps/objects.py:11)."""

    mu: Array     # (T, d)
    sigma: Array  # (T, d, d)

    @property
    def horizon(self) -> int:
        return self.mu.shape[0]


class MatrixNormalParams(NamedTuple):
    """Gaussian over vec([A B c]) (column-major vec), stacked over the horizon.

    Mirrors ``MatrixNormalParameters`` (rgps/objects.py:37-75); ``dm_param =
    dx * (dx + du + 1)``.
    """

    mu: Array     # (T, p)
    sigma: Array  # (T, p, p)

    @property
    def horizon(self) -> int:
        return self.mu.shape[0]


def matrices_from_vec(mu_t: Array, dx: int, du: int) -> tuple[Array, Array, Array]:
    """Unpack a column-major vec([A B c]) parameter vector into (A, B, c).

    Matches ``MatrixNormalParameters.matrices`` (rgps/objects.py:53-58), which
    reshapes with ``order='F'``.
    """
    A = mu_t[: dx * dx].reshape((dx, dx), order="F")
    B = mu_t[dx * dx : dx * dx + dx * du].reshape((dx, du), order="F")
    c = mu_t[dx * dx + dx * du :].reshape((dx,), order="F")
    return A, B, c


def vec_from_matrices(A: Array, B: Array, c: Array) -> Array:
    """Column-major vec([A B c]) — inverse of :func:`matrices_from_vec`.

    Matches the nominal-parameter assembly in rgps/mbrgps.py:751-754.
    """
    dx = A.shape[0]
    ABc = jnp.concatenate([A, B, c.reshape(dx, 1)], axis=1)
    return ABc.T.reshape(-1)  # column-major vec == row-major vec of transpose


def symmetrize(M: Array) -> Array:
    """0.5 (M + Mᵀ) over the trailing two axes (used pervasively by the reference)."""
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))
