"""Parallel-in-time Riccati recursion via ``lax.associative_scan``.

The LQR backward pass is an associative operation on conditional value-function
elements (Särkkä & García-Fernández, *Temporal Parallelization of Dynamic Programming*;
see PAPERS.md "The Parallelization of Riccati Recursion"): each step contributes

    V_e(x, z) = ½ (z − A x − b)ᵀ C⁻¹ (z − A x − b) + ½ xᵀ J x − ηᵀ x

and composition (minimizing over the intermediate state) is closed-form in
(A, b, C, η, J).  A suffix ``associative_scan`` therefore computes **all** value
functions V_t in O(log T) parallel depth instead of the O(T) sequential scan of the
C++ reference (ilqr/src/util.cpp:126) — this is the block-tridiagonal-KKT
factorization view of the horizon, and the lever for both wide-MXU utilization on one
chip (the scan body is batched small-matmul work) and horizon sharding across chips
(:func:`sharded_backward` exchanges only per-block composite elements over ICI).

Elements compose in the ½-convention quadratic model
    cost_t(x, u) = ½xᵀQx + qᵀx + ½uᵀRu + rᵀu + xᵀMu,   z = F x + L u + c.
Wrappers map the reference's two conventions onto it:

* :func:`priccati_backward` — absolute convention (riccati/riccati.py:100-126):
  Q = 2·Cxx etc., returns V in the x ᵀVx + vᵀx storage of the reference.
* :func:`pilqr_backward`    — delta convention (ilqr/src/util.cpp:83-182) at λ = 0;
  exact agreement with the sequential kernel is a unit test.  (The λ > 0 LM path of
  the sequential kernel damps the value update itself and is inherently sequential;
  the solvers use the parallel path opportunistically when λ is tiny.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..utils.psd import chol_solve
from .types import (
    LinearDynamics,
    LinearPolicy,
    QuadraticCost,
    QuadraticValue,
    symmetrize,
)


class RiccatiElement(NamedTuple):
    A: Array    # (..., dx, dx)
    b: Array    # (..., dx)
    C: Array    # (..., dx, dx)
    eta: Array  # (..., dx)
    J: Array    # (..., dx, dx)


def combine(e1: RiccatiElement, e2: RiccatiElement) -> RiccatiElement:
    """Compose two conditional value elements: (e1 ⊗ e2)(x, z) = min_y e1(x,y) + e2(y,z).

    Batched over leading axes (as required by ``lax.associative_scan``).
    """
    dx = e1.A.shape[-1]
    eye = jnp.eye(dx, dtype=e1.A.dtype)

    # G = (I + C1 J2)^{-1}; (I + J2 C1)^{-1} = Gᵀ for symmetric C, J
    G = jnp.linalg.solve(eye + e1.C @ e2.J, jnp.broadcast_to(eye, e1.C.shape))
    Gt = jnp.swapaxes(G, -1, -2)

    A12 = e2.A @ G @ e1.A
    b12 = _mv(e2.A @ G, e1.b + _mv(e1.C, e2.eta)) + e2.b
    C12 = symmetrize(e2.A @ G @ e1.C @ jnp.swapaxes(e2.A, -1, -2) + e2.C)
    eta12 = _mv(jnp.swapaxes(e1.A, -1, -2) @ Gt, e2.eta - _mv(e2.J, e1.b)) + e1.eta
    J12 = symmetrize(jnp.swapaxes(e1.A, -1, -2) @ Gt @ e2.J @ e1.A + e1.J)
    return RiccatiElement(A=A12, b=b12, C=C12, eta=eta12, J=J12)


def _mv(M: Array, v: Array) -> Array:
    """Batched matrix-vector product over leading axes."""
    return jnp.einsum("...ij,...j->...i", M, v)


def make_elements(
    Q: Array, q: Array, R: Array, r: Array, M: Array,
    F: Array, L: Array, c: Array,
    Q_T: Array, q_T: Array,
) -> RiccatiElement:
    """Per-step elements for the ½-convention model plus the terminal element.

    Returns stacked elements of length T+1 (terminal last).
    """
    dx = F.shape[-1]

    def one(Q, q, R, r, M, F, L, c):
        chol_R = jnp.linalg.cholesky(symmetrize(R))
        RiM = chol_solve(chol_R, jnp.swapaxes(M, -1, -2))   # R⁻¹ Mᵀ
        Rir = chol_solve(chol_R, r)                          # R⁻¹ r
        RiL = chol_solve(chol_R, jnp.swapaxes(L, -1, -2))   # R⁻¹ Lᵀ
        A = F - L @ RiM
        b = c - L @ Rir
        C = symmetrize(L @ RiL)
        J = symmetrize(Q - M @ RiM)
        eta = -(q - M @ Rir)
        return RiccatiElement(A=A, b=b, C=C, eta=eta, J=J)

    els = jax.vmap(one)(Q, q, R, r, M, F, L, c)

    zero_m = jnp.zeros((1, dx, dx), F.dtype)
    zero_v = jnp.zeros((1, dx), F.dtype)
    term = RiccatiElement(
        A=zero_m, b=zero_v, C=zero_m, eta=-q_T[None], J=Q_T[None]
    )
    return jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b], axis=0), els, term
    )


def suffix_scan(elements: RiccatiElement) -> RiccatiElement:
    """result[t] = e_t ⊗ e_{t+1} ⊗ … ⊗ e_T, all t, in O(log T) depth.

    ``associative_scan(reverse=True)`` combines operands in *reversed* array order,
    so the binary op is flipped to keep composition time-ordered.
    """
    return lax.associative_scan(
        lambda x, y: combine(y, x), elements, reverse=True
    )


def _gains(Q_half, R_half, r_half, M_half, F, L, c, S_next, s_next):
    """Per-step feedback/feedforward from the next-step ½-model value."""
    Quu = R_half + jnp.swapaxes(L, -1, -2) @ S_next @ L
    chol = jnp.linalg.cholesky(symmetrize(Quu))
    K = -chol_solve(chol, jnp.swapaxes(L, -1, -2) @ S_next @ F
                    + jnp.swapaxes(M_half, -1, -2))
    kff = -chol_solve(chol, _mv(jnp.swapaxes(L, -1, -2), _mv(S_next, c) + s_next)
                      + r_half)
    return K, kff


def priccati_backward(
    cost: QuadraticCost, dyn: LinearDynamics
) -> tuple[LinearPolicy, QuadraticValue]:
    """Parallel-in-time equivalent of :func:`core.scan_lqr.riccati_backward`
    (absolute convention: Cxx = ½-scaled Hessians, value stored as xᵀVx + vᵀx)."""
    T = dyn.horizon
    Q, q = 2.0 * cost.Cxx[:T], cost.cx[:T]
    R, r = 2.0 * cost.Cuu[:T], cost.cu[:T]
    M = 2.0 * cost.Cxu[:T]
    Q_T, q_T = 2.0 * cost.Cxx[T], cost.cx[T]

    els = make_elements(Q, q, R, r, M, dyn.A, dyn.B, dyn.c, Q_T, q_T)
    suf = suffix_scan(els)

    # ½-model value: S_t = J_t, s_t = −η_t;  reference storage: V = S/2, v = s
    S = suf.J
    s = -suf.eta

    K, kff = jax.vmap(_gains)(
        Q, R, r, M, dyn.A, dyn.B, dyn.c, S[1:], s[1:]
    )
    value = QuadraticValue(V=0.5 * S, v=s, v0=jnp.zeros(T + 1, S.dtype))
    return LinearPolicy(K=K, kff=kff), value


def pilqr_backward(
    cost: QuadraticCost, A: Array, B: Array
) -> tuple[LinearPolicy, QuadraticValue, Array]:
    """Parallel-in-time equivalent of the unregularized iLQR backward pass
    (ilqr/src/util.cpp:83-182 at λ = 0).  Also returns the dV improvement pair."""
    T = A.shape[0]
    c = jnp.zeros((T, A.shape[-1]), A.dtype)
    Q, q = cost.Cxx[:T], cost.cx[:T]
    R, r = cost.Cuu[:T], cost.cu[:T]
    M = cost.Cxu[:T]

    els = make_elements(Q, q, R, r, M, A, B, c, cost.Cxx[T], cost.cx[T])
    suf = suffix_scan(els)
    S, s = suf.J, -suf.eta

    K, kff = jax.vmap(_gains)(Q, R, r, M, A, B, c, S[1:], s[1:])

    # dV pair (ilqr/src/util.cpp:154): Σ_t [kffᵀqu, ½ kffᵀ Quu kff]
    def dv_t(K_t, kff_t, R_t, r_t, B_t, S_n, s_n):
        Quu = R_t + B_t.T @ S_n @ B_t
        qu = r_t + B_t.T @ s_n
        return jnp.stack([kff_t @ qu, 0.5 * kff_t @ Quu @ kff_t])

    dV = jnp.sum(jax.vmap(dv_t)(K, kff, R, r, B, S[1:], s[1:]), axis=0)
    value = QuadraticValue(V=S, v=s, v0=jnp.zeros(T + 1, S.dtype))
    return LinearPolicy(K=K, kff=kff), value, dV


# --------------------------------------------------------------------------------------
# Lane-major parallel Riccati
# --------------------------------------------------------------------------------------
#
# The element leaves above are (T, dx, dx) cubes, so every combine works on tiny
# dx-sized trailing dims (a (T, 4, 4) solve is a batch of 4x4 problems).
# The lane-major variant stores each matrix ENTRY as its own plane of shape
# (..., T): the horizon (and any problem batch) is the contiguous vector axis, and
# the combine becomes unrolled scalar recurrences over whole planes — the same
# trick as core/pallas_lqr.py, but in plain XLA because ``lax.associative_scan``
# already provides the O(log T) schedule.  The (I + C₁J₂)⁻¹ solve becomes an
# unrolled Gauss–Jordan elimination with per-lane partial pivoting (eigenvalues ≥ 1
# of I + C₁J₂ do NOT keep the leading principal minors away from zero, so pivoting
# is required; the jnp.linalg path above remains the reference the tests compare
# against).


class LaneElement(NamedTuple):
    A: Array    # (dx*dx, ..., T)
    b: Array    # (dx,    ..., T)
    C: Array    # (dx*dx, ..., T)
    eta: Array  # (dx,    ..., T)
    J: Array    # (dx*dx, ..., T)


def _to_planes(M: Array) -> Array:
    """(T, n, m) → (n*m, T) entry-major planes (leading batch axes allowed)."""
    n, m = M.shape[-2], M.shape[-1]
    return jnp.moveaxis(M.reshape(M.shape[:-2] + (n * m,)), -1, 0).reshape(
        (n * m,) + M.shape[:-2]
    )


def _from_planes(P: Array, n: int, m: int) -> Array:
    """(n*m, ..., T) → (..., T, n, m)."""
    out = jnp.moveaxis(P, 0, -1)           # (..., T, n*m)
    return out.reshape(out.shape[:-1] + (n, m))


def _rows(P: Array, n: int, m: int):
    return [[P[i * m + j] for j in range(m)] for i in range(n)]


def _lmm(A, B):
    n, k, m = len(A), len(B), len(B[0])
    return [[sum(A[i][l] * B[l][j] for l in range(k)) for j in range(m)]
            for i in range(n)]


def _lmv(A, x):
    return [sum(A[i][j] * x[j] for j in range(len(x))) for i in range(len(A))]


def _lt(A):
    return [[A[i][j] for i in range(len(A))] for j in range(len(A[0]))]


def _gj_inv(A):
    """Unrolled Gauss–Jordan inverse with partial pivoting of a small matrix per lane.

    Eigenvalue bounds on ``I + C1·J2`` (all ≥ 1) do NOT bound its leading principal
    minors, so a pivot-free elimination can pass arbitrarily close to zero for valid
    PSD inputs.  Each step therefore compare-swaps the current pivot row against the
    remaining rows per lane (running-max == partial pivoting), unrolled into
    straight-line ``jnp.where`` selects — cheap for the dx ≤ 8 blocks this serves.
    """
    n = len(A)
    M = [row[:] for row in A]
    one = jnp.ones_like(A[0][0])
    zero = jnp.zeros_like(A[0][0])
    I = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for k in range(n):
        # partial pivoting: bubble the largest |column-k| entry into row k per lane
        for i in range(k + 1, n):
            swap = jnp.abs(M[i][k]) > jnp.abs(M[k][k])
            for j in range(n):
                mk, mi = M[k][j], M[i][j]
                M[k][j] = jnp.where(swap, mi, mk)
                M[i][j] = jnp.where(swap, mk, mi)
                ik, ii = I[k][j], I[i][j]
                I[k][j] = jnp.where(swap, ii, ik)
                I[i][j] = jnp.where(swap, ik, ii)
        piv = 1.0 / M[k][k]
        M[k] = [e * piv for e in M[k]]
        I[k] = [e * piv for e in I[k]]
        for i in range(n):
            if i == k:
                continue
            f = M[i][k]
            M[i] = [M[i][j] - f * M[k][j] for j in range(n)]
            I[i] = [I[i][j] - f * I[k][j] for j in range(n)]
    return I


def _combine_lanes(e1: LaneElement, e2: LaneElement, dx: int) -> LaneElement:
    """The composition of :func:`combine` in entry-plane form."""
    A1, C1, J1 = _rows(e1.A, dx, dx), _rows(e1.C, dx, dx), _rows(e1.J, dx, dx)
    A2, C2, J2 = _rows(e2.A, dx, dx), _rows(e2.C, dx, dx), _rows(e2.J, dx, dx)
    b1 = [e1.b[i] for i in range(dx)]
    b2 = [e2.b[i] for i in range(dx)]
    n1 = [e1.eta[i] for i in range(dx)]
    n2 = [e2.eta[i] for i in range(dx)]

    C1J2 = _lmm(C1, J2)
    M = [[C1J2[i][j] + (1.0 if i == j else 0.0) for j in range(dx)]
         for i in range(dx)]
    G = _gj_inv(M)                      # (I + C1 J2)^{-1}
    Gt = _lt(G)

    A2G = _lmm(A2, G)
    A12 = _lmm(A2G, A1)
    b12 = [s + b2[i] for i, s in enumerate(_lmv(A2G, [
        b1[k] + sum(C1[k][l] * n2[l] for l in range(dx)) for k in range(dx)
    ]))]
    C12 = _lmm(_lmm(A2G, C1), _lt(A2))
    C12 = [[0.5 * (C12[i][j] + C12[j][i]) + C2[i][j] for j in range(dx)]
           for i in range(dx)]
    A1tGt = _lmm(_lt(A1), Gt)
    eta12 = [s + n1[i] for i, s in enumerate(_lmv(A1tGt, [
        n2[k] - sum(J2[k][l] * b1[l] for l in range(dx)) for k in range(dx)
    ]))]
    J12 = _lmm(_lmm(A1tGt, J2), A1)
    J12 = [[0.5 * (J12[i][j] + J12[j][i]) + J1[i][j] for j in range(dx)]
           for i in range(dx)]

    stack = lambda rows: jnp.stack([e for row in rows for e in row])
    return LaneElement(
        A=stack(A12), b=jnp.stack(b12), C=stack(C12),
        eta=jnp.stack(eta12), J=stack(J12),
    )


def suffix_scan_lanes(elements: RiccatiElement) -> tuple[Array, Array]:
    """Lane-major suffix scan: returns (S (T+1, dx, dx), s (T+1, dx)) with
    S = J-planes, s = −η-planes of the suffix composites — the only parts the
    gain computation consumes."""
    dx = elements.A.shape[-1]
    els = LaneElement(
        A=_to_planes(elements.A),
        b=jnp.moveaxis(elements.b, -1, 0),
        C=_to_planes(elements.C),
        eta=jnp.moveaxis(elements.eta, -1, 0),
        J=_to_planes(elements.J),
    )
    suf = lax.associative_scan(
        lambda x, y: _combine_lanes(y, x, dx), els, reverse=True,
        axis=els.A.ndim - 1,  # scan axis is last on every leaf (rank is uniform)
    )
    S = _from_planes(suf.J, dx, dx)
    s = -jnp.moveaxis(suf.eta, 0, -1)
    return S, s


def pilqr_backward_lanes(
    cost: QuadraticCost, A: Array, B: Array
) -> tuple[LinearPolicy, QuadraticValue, Array]:
    """Lane-major counterpart of :func:`pilqr_backward` (identical contract)."""
    T = A.shape[0]
    c = jnp.zeros((T, A.shape[-1]), A.dtype)
    Q, q = cost.Cxx[:T], cost.cx[:T]
    R, r = cost.Cuu[:T], cost.cu[:T]
    M = cost.Cxu[:T]

    els = make_elements(Q, q, R, r, M, A, B, c, cost.Cxx[T], cost.cx[T])
    S, s = suffix_scan_lanes(els)

    K, kff = jax.vmap(_gains)(Q, R, r, M, A, B, c, S[1:], s[1:])

    def dv_t(K_t, kff_t, R_t, r_t, B_t, S_n, s_n):
        Quu = R_t + B_t.T @ S_n @ B_t
        qu = r_t + B_t.T @ s_n
        return jnp.stack([kff_t @ qu, 0.5 * kff_t @ Quu @ kff_t])

    dV = jnp.sum(jax.vmap(dv_t)(K, kff, R, r, B, S[1:], s[1:]), axis=0)
    value = QuadraticValue(V=S, v=s, v0=jnp.zeros(T + 1, S.dtype))
    return LinearPolicy(K=K, kff=kff), value, dV


# --------------------------------------------------------------------------------------
# Horizon sharding across devices
# --------------------------------------------------------------------------------------


def _identity_element(dx: int, dtype) -> RiccatiElement:
    """The neutral element of :func:`combine` (A = I, everything else 0)."""
    return RiccatiElement(
        A=jnp.eye(dx, dtype=dtype),
        b=jnp.zeros(dx, dtype),
        C=jnp.zeros((dx, dx), dtype),
        eta=jnp.zeros(dx, dtype),
        J=jnp.zeros((dx, dx), dtype),
    )


def _suffix_tail_ppermute(
    total, axis_name: str, n_dev: int, dx: int, dtype,
    combine_fn=None, ident=None,
):
    """Exclusive suffix composition of the per-device block composites via a
    log-depth doubling ladder of ``ppermute`` neighbor exchanges.

    Device i holds its block composite c_i and needs tail_i = c_{i+1} ⊗ … ⊗ c_{N−1}.
    Each ladder step moves one element a distance ``d`` down the axis and doubles
    the span: S_i ← S_i ⊗ S_{i+d} (receive-from-the-right), so after ⌈log₂ N⌉
    steps S_i is the inclusive suffix; one final distance-1 shift makes it
    exclusive.  Communication is O(1) elements per device per step (⌈log₂ N⌉ + 1
    ``ppermute``s total) and the fold work is distributed — replacing the
    round-1 ``all_gather`` + per-device O(N) refold, whose communication and
    compute both scaled linearly with the mesh size.

    Works for ANY associative element monoid: ``combine_fn``/``ident`` default
    to the Riccati element algebra, the affine ladder of
    :func:`sharded_bsp_backward` passes its own.
    """
    if combine_fn is None:
        combine_fn = combine
    if ident is None:
        ident = _identity_element(dx, dtype)
    idx = jax.lax.axis_index(axis_name)
    S = total
    d = 1
    while d < n_dev:
        recv = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(
                x, axis_name, [(j, j - d) for j in range(d, n_dev)]
            ),
            S,
        )
        # devices i ≥ N − d receive zeros (no source) — their span already
        # reaches the end, so keep S unchanged there
        merged = combine_fn(S, recv)
        S = jax.tree_util.tree_map(
            lambda m, s: jnp.where(idx < n_dev - d, m, s), merged, S
        )
        d *= 2
    tail = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(
            x, axis_name, [(j, j - 1) for j in range(1, n_dev)]
        ),
        S,
    )
    # the last device's tail is the identity (nothing after it)
    return jax.tree_util.tree_map(
        lambda t, i: jnp.where(
            idx < n_dev - 1, t, jax.lax.pcast(i, axis_name, to="varying")
        ),
        tail, ident,
    )


def sharded_backward(
    cost: QuadraticCost,
    dyn: LinearDynamics,
    mesh,
    axis_name: str = "time",
):
    """Horizon-block-sharded parallel Riccati (absolute convention).

    Each device runs the suffix scan on its local block of elements; the per-block
    composite elements (one small (A, b, C, η, J) tuple per device) are then
    combined across the mesh axis with a log-depth ``ppermute`` doubling ladder
    (:func:`_suffix_tail_ppermute`) — O(1) halo traffic per device per level, fold
    distributed — and each local suffix is completed by composing with its tail.
    Returns the same (policy, value) as :func:`priccati_backward`.
    """
    T = dyn.horizon
    Q, q = 2.0 * cost.Cxx[:T], cost.cx[:T]
    R, r = 2.0 * cost.Cuu[:T], cost.cu[:T]
    M = 2.0 * cost.Cxu[:T]
    els = make_elements(Q, q, R, r, M, dyn.A, dyn.B, dyn.c,
                        2.0 * cost.Cxx[T], cost.cx[T])

    S, s = _sharded_suffix(els, mesh, axis_name, T, dyn.A.shape[-1], dyn.A.dtype)
    K, kff = jax.vmap(_gains)(Q, R, r, M, dyn.A, dyn.B, dyn.c, S[1:], s[1:])
    value = QuadraticValue(V=0.5 * S, v=s, v0=jnp.zeros(T + 1, S.dtype))
    return LinearPolicy(K=K, kff=kff), value


def _sharded_suffix(els: RiccatiElement, mesh, axis_name, T, dx, dtype):
    """Shared machinery of the sharded backward passes: pad the T+1 elements to
    the axis size, run per-device local suffix scans, exchange block composites
    with the ppermute ladder, and return the value planes (S, s)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis_name]
    pad = (-(T + 1)) % n_dev
    eye = jnp.broadcast_to(jnp.eye(dx, dtype=dtype), (pad, dx, dx))
    zeros_m = jnp.zeros((pad, dx, dx), dtype)
    zeros_v = jnp.zeros((pad, dx), dtype)
    identity = RiccatiElement(A=eye, b=zeros_v, C=zeros_m, eta=zeros_v, J=zeros_m)
    els = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b], axis=0), els, identity
    )

    def local_block(block: RiccatiElement) -> RiccatiElement:
        # local suffix scan within this device's time block
        local = lax.associative_scan(lambda x, y: combine(y, x), block, reverse=True)
        total = jax.tree_util.tree_map(lambda x: x[0], local)  # block composite

        tail = _suffix_tail_ppermute(total, axis_name, n_dev, dx, dtype)
        tail_b = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (local.A.shape[0],) + x.shape), tail
        )
        return combine(local, tail_b)

    spec = RiccatiElement(
        A=P(axis_name), b=P(axis_name), C=P(axis_name), eta=P(axis_name), J=P(axis_name)
    )
    suf = shard_map(
        local_block, mesh=mesh, in_specs=(spec,), out_specs=spec
    )(els)
    return suf.J[: T + 1], -suf.eta[: T + 1]


def sharded_ilqr_backward(
    cost: QuadraticCost,
    A: Array,
    B: Array,
    mesh,
    axis_name: str = "time",
    lmbda: Array | float = 0.0,
) -> tuple[LinearPolicy, QuadraticValue, Array, Array]:
    """Horizon-sharded parallel iLQR backward pass (delta convention).

    Levenberg–Marquardt semantics: λ is folded into the action Hessian
    (``Cuu + λI``), i.e. the pass solves the λ-regularized *problem* exactly —
    identical to ilqr/src/util.cpp:83-182 at λ = 0, a well-defined proximal
    variant for λ > 0 (the C++ recursion regularizes only the gain solve and is
    inherently sequential; see the module docstring).  Returns
    (policy, value, dV, diverged) — diverged is a NaN/Inf flag on the gains, the
    associative-scan analogue of the sequential Cholesky-failure flag.
    """
    T = A.shape[0]
    dx, du = A.shape[-1], B.shape[-1]
    c = jnp.zeros((T, dx), A.dtype)
    lam_eye = lmbda * jnp.eye(du, dtype=A.dtype)
    Q, q = cost.Cxx[:T], cost.cx[:T]
    R = cost.Cuu[:T] + lam_eye
    r = cost.cu[:T]
    M = cost.Cxu[:T]

    els = make_elements(Q, q, R, r, M, A, B, c, cost.Cxx[T], cost.cx[T])
    S, s = _sharded_suffix(els, mesh, axis_name, T, dx, A.dtype)
    K, kff = jax.vmap(_gains)(Q, R, r, M, A, B, c, S[1:], s[1:])

    def dv_t(kff_t, R_t, r_t, B_t, S_n, s_n):
        Quu = R_t + B_t.T @ S_n @ B_t
        qu = r_t + B_t.T @ s_n
        return jnp.stack([kff_t @ qu, 0.5 * kff_t @ Quu @ kff_t])

    dV = jnp.sum(jax.vmap(dv_t)(kff, R, r, B, S[1:], s[1:]), axis=0)
    diverged = ~(
        jnp.all(jnp.isfinite(K)) & jnp.all(jnp.isfinite(kff)) & jnp.all(jnp.isfinite(S))
    )
    value = QuadraticValue(V=S, v=s, v0=jnp.zeros(T + 1, S.dtype))
    return LinearPolicy(K=K, kff=kff), value, dV, diverged


def pilqr_backward_reg(
    cost: QuadraticCost, A: Array, B: Array, lmbda: Array | float = 0.0
) -> tuple[LinearPolicy, QuadraticValue, Array, Array]:
    """Single-device lane-major parallel iLQR backward with the same λ-folded
    semantics as :func:`sharded_ilqr_backward` (λ into Cuu) — the host-local
    reference for the sharded path and the ``backward='pscan'`` solver engine."""
    du = B.shape[-1]
    lam_eye = lmbda * jnp.eye(du, dtype=A.dtype)
    ctl, value, dV = pilqr_backward_lanes(
        cost._replace(Cuu=cost.Cuu + lam_eye), A, B
    )
    diverged = ~(
        jnp.all(jnp.isfinite(ctl.K))
        & jnp.all(jnp.isfinite(ctl.kff))
        & jnp.all(jnp.isfinite(value.V))
    )
    return ctl, value, dV, diverged


def sharded_gps_backward(
    agcost: QuadraticCost,
    dyn,
    alpha: Array,
    mesh,
    axis_name: str = "time",
):
    """Horizon-block-sharded soft-KL GPS backward pass — the time-axis-parallel
    twin of :func:`core.scan_lqr.gps_backward` (gps/src/util.cpp:272-374).

    The soft (Gaussian-policy) value recursion reduces ALGEBRAICALLY to the
    hard Riccati recursion on the α-augmented cost: with D = Cuu + BᵀV'B and
    H = Cxu + AᵀV'B,

        V = −a(Qxx + QuxᵀK) = Cxx + AᵀV'A − H D⁻¹ Hᵀ
        v = −a(qx + 2Quxᵀkff) = cx + 2AᵀV'c + Aᵀv' − H D⁻¹ d

    i.e. the −1/α scaling of the Q-blocks cancels exactly in the policy
    completion, so the (V, v) planes come from the SAME associative
    :func:`RiccatiElement` ladder as :func:`sharded_backward` (ppermute doubling
    across the mesh axis).  α re-enters only in the per-step outputs — the
    Q-blocks, the policy covariance Σ_ctl = ½(−Quu)⁻¹, and the entropy/constant
    chain v0 (which no other quantity feeds back on: a reverse cumsum).

    Returns the exact (policy, value, qvalue, diverged) tuple of gps_backward.
    """
    from .scan_lqr import _LOG_2PI
    from .types import LinearGaussianPolicy, QuadraticQValue

    T = dyn.horizon
    dx, du = dyn.A.shape[-1], dyn.B.shape[-1]
    dtype = dyn.A.dtype

    Q, q = 2.0 * agcost.Cxx[:T], agcost.cx[:T]
    R, r = 2.0 * agcost.Cuu[:T], agcost.cu[:T]
    M = 2.0 * agcost.Cxu[:T]
    els = make_elements(Q, q, R, r, M, dyn.A, dyn.B, dyn.c,
                        2.0 * agcost.Cxx[T], agcost.cx[T])
    S, s = _sharded_suffix(els, mesh, axis_name, T, dx, dtype)
    V_pl, v_pl = 0.5 * S, s  # value planes, xᵀVx + vᵀx convention

    def soft_outputs(Cxx, cx, Cuu, cu, Cxu, c0, A, B, c, sig, a, V_n, v_n):
        """gps_backward's per-step body with (V', v') read off the ladder."""
        Qxx = -(Cxx + A.T @ V_n @ A) / a
        Quu = -(Cuu + B.T @ V_n @ B) / a
        Qux = -(Cxu + A.T @ V_n @ B).T / a
        qu = -(cu + 2.0 * B.T @ V_n @ c + B.T @ v_n) / a
        qx = -(cx + 2.0 * A.T @ V_n @ c + A.T @ v_n) / a

        neg_chol = jnp.linalg.cholesky(-symmetrize(Quu))
        step_bad = ~jnp.all(jnp.isfinite(neg_chol))
        safe_chol = jnp.where(
            jnp.isfinite(neg_chol), neg_chol, jnp.eye(du, dtype=neg_chol.dtype)
        )
        K = chol_solve(safe_chol, Qux)
        kff = 0.5 * chol_solve(safe_chol, qu)
        sigma_ctl = symmetrize(
            0.5 * chol_solve(safe_chol, jnp.eye(du, dtype=safe_chol.dtype))
        )
        logdet_m2Quu = du * jnp.log(2.0) + 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(neg_chol))
        )
        # v0 increment: v0_t = v0_{t+1} + g_t (the −a·q0 expansion minus its
        # v0' term, plus the policy/entropy parts)
        g = (
            -a * 0.5 * (qu @ kff)
            + c0 + c @ V_n @ c + jnp.trace(V_n @ sig) + v_n @ c
            - a * 0.5 * (du * _LOG_2PI - logdet_m2Quu)
        )
        return K, kff, sigma_ctl, Qxx, Quu, Qux, qx, qu, g, step_bad

    K, kff, sigma_ctl, Qxx, Quu, Qux, qx, qu, g, step_bad = jax.vmap(
        soft_outputs
    )(
        agcost.Cxx[:T], agcost.cx[:T], agcost.Cuu[:T], agcost.cu[:T],
        agcost.Cxu[:T], agcost.c0[:T],
        dyn.A, dyn.B, dyn.c, dyn.sigma, alpha, V_pl[1:], v_pl[1:],
    )

    # constant chain: reverse cumulative sum from the terminal c0
    v0_T = agcost.c0[T]
    v0 = jnp.concatenate([
        v0_T + jnp.cumsum(g[::-1])[::-1], v0_T[None]
    ])
    q0 = -(agcost.c0[:T] + v0[1:]
           + jnp.einsum("ti,tij,tj->t", dyn.c, V_pl[1:], dyn.c)
           + jnp.einsum("tij,tji->t", V_pl[1:], dyn.sigma)
           + jnp.einsum("ti,ti->t", v_pl[1:], dyn.c)) / alpha

    value = QuadraticValue(V=V_pl, v=v_pl, v0=v0)
    qvalue = QuadraticQValue(Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, q0=q0)
    policy = LinearGaussianPolicy(K=K, kff=kff, sigma=sigma_ctl)
    diverged = jnp.any(step_bad) | ~jnp.all(jnp.isfinite(S))
    return policy, value, qvalue, diverged


# --------------------------------------------------------------------------------------
# Parallel-in-time belief-space (BSP) backward pass
# --------------------------------------------------------------------------------------
#
# The (S, s, τ) belief-value recursion (bspilqr/src/util.cpp:83-204) decomposes into
# two associative ladders once λ is folded into the action Hessian:
#
#   pass 1 — S alone: with R̃ = R + λI the update
#       S = Q + FᵀS'F − (P + FᵀS'G)(R̃ + GᵀS'G)⁻¹(P + FᵀS'G)ᵀ
#     is EXACTLY the hard Riccati LFT, so the S planes ride the same
#     :class:`RiccatiElement` suffix ladder as :func:`sharded_backward`
#     (zero linear channel — the belief linear channel is coupled to τ and
#     cannot ride the η slot).
#
#   pass 2 — (s, τ) jointly: with the EXACT gain K = −D̃⁻¹(P + FᵀS'G)ᵀ the
#     cross terms K ᵀD̃kff + Eᵀkff in the s-update cancel (KᵀD̃ + Eᵀ = 0), so
#       s = (F + GK)ᵀ s' + (T + VK)ᵀ τ' + [q + Kᵀr + ½(X + ZK)ᵀ vec S']
#       τ = Uᵀ τ' + [p + ½ Yᵀ vec S']
#     is an AFFINE backward recursion in z = (s, τ) ∈ ℝ^{b+b²} whose
#     coefficients are known once pass 1 lands — a second associative suffix
#     scan over (M, w) affine maps.
#
# λ-folded semantics (same contract as :func:`sharded_ilqr_backward`): the pass
# solves the λ-regularized problem exactly — identical to the sequential
# :func:`core.belief.bsp_backward` at λ = 0 (either reg mode), a well-defined
# proximal variant for λ > 0 (the C++ recursion regularizes only the gain solve
# — e.g. S keeps the unregularized D in KᵀDK — and is inherently sequential;
# ``reg`` is ignored here).


class AffineElement(NamedTuple):
    """z_earlier = M z_later + w, composed associatively (suffix ladder)."""

    M: Array  # (..., d, d)
    w: Array  # (..., d)


def _affine_combine(e1: AffineElement, e2: AffineElement) -> AffineElement:
    """Compose e1 (earlier) with e2 (later): z = M1 (M2 z'' + w2) + w1."""
    return AffineElement(M=e1.M @ e2.M, w=_mv(e1.M, e2.w) + e1.w)


def _affine_identity(d: int, dtype) -> AffineElement:
    return AffineElement(M=jnp.eye(d, dtype=dtype), w=jnp.zeros(d, dtype))


def _affine_suffix(els: AffineElement) -> Array:
    """Local (single-device) suffix scan of affine maps; returns the w of each
    suffix composite — i.e. z_t when the last element is (M=0, w=z_T)."""
    suf = lax.associative_scan(
        lambda x, y: _affine_combine(y, x), els, reverse=True
    )
    return suf.w


def _sharded_affine_suffix(els: AffineElement, mesh, axis_name, T, d, dtype):
    """Horizon-block-sharded suffix scan of affine maps — the affine-monoid twin
    of :func:`_sharded_suffix` (local block scans + ppermute doubling ladder)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis_name]
    pad = (-(T + 1)) % n_dev
    ident = AffineElement(
        M=jnp.broadcast_to(jnp.eye(d, dtype=dtype), (pad, d, d)),
        w=jnp.zeros((pad, d), dtype),
    )
    els = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b], axis=0), els, ident
    )

    def local_block(block: AffineElement) -> AffineElement:
        local = lax.associative_scan(
            lambda x, y: _affine_combine(y, x), block, reverse=True
        )
        total = jax.tree_util.tree_map(lambda x: x[0], local)
        tail = _suffix_tail_ppermute(
            total, axis_name, n_dev, d, dtype,
            combine_fn=_affine_combine, ident=_affine_identity(d, dtype),
        )
        tail_b = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (local.M.shape[0],) + x.shape), tail
        )
        return _affine_combine(local, tail_b)

    spec = AffineElement(M=P(axis_name), w=P(axis_name))
    suf = shard_map(
        local_block, mesh=mesh, in_specs=(spec,), out_specs=spec
    )(els)
    return suf.w[: T + 1]


def sharded_bsp_backward(
    cost,
    dyn,
    lmbda: Array | float,
    mesh=None,
    axis_name: str = "time",
):
    """Parallel-in-time belief-space backward pass (λ-folded semantics, see the
    section comment above) — the time-axis twin of
    :func:`core.belief.bsp_backward` (bspilqr/src/util.cpp:83-204).

    ``cost`` / ``dyn`` are the :class:`core.belief.BeliefCostExpansion` /
    :class:`BeliefDynamicsExpansion` stacks.  With ``mesh=None`` both ladders
    run as local ``associative_scan``s (the single-device parallel-in-time
    engine, O(log T) depth); with a mesh the horizon blocks are sharded across
    ``axis_name`` and composites exchanged via the log-depth ppermute ladder.

    Returns the exact ``(policy, S, s, tau, dS, diverged)`` contract of
    ``bsp_backward`` — equal to it at λ = 0, λ-folded proximal variant beyond.
    """
    T = dyn.F.shape[0]
    b = dyn.F.shape[-1]
    a = dyn.G.shape[-1]
    dt = dyn.F.dtype
    eye_a = jnp.eye(a, dtype=dt)
    lam = jnp.asarray(lmbda, dt)

    # ---- pass 1: S planes on the Riccati element ladder (zero linear channel)
    zeros_qb = jnp.zeros((T, b), dt)
    zeros_ra = jnp.zeros((T, a), dt)
    R_fold = cost.R[:T] + lam * eye_a
    els = make_elements(
        cost.Q[:T], zeros_qb, R_fold, zeros_ra, cost.P[:T],
        dyn.F, dyn.G, zeros_qb, cost.Q[T], jnp.zeros(b, dt),
    )
    if mesh is None:
        S = suffix_scan(els).J
    else:
        S, _ = _sharded_suffix(els, mesh, axis_name, T, b, dt)

    # ---- per-step gains + affine (s, τ) coefficients from S'
    def per_step(Q, q, R, r, P, p, F, G, X, Y, Z, T_, U, V, S_n):
        D = R + lam * eye_a + G.T @ S_n @ G
        E_row = P + F.T @ S_n @ G                      # (b, a)
        chol = jnp.linalg.cholesky(symmetrize(D))
        bad = ~jnp.all(jnp.isfinite(chol))
        safe_chol = jnp.where(jnp.isfinite(chol), chol, eye_a)
        K = -chol_solve(safe_chol, E_row.T)            # (a, b)
        vecS = S_n.reshape(-1)
        M_el = jnp.block([
            [(F + G @ K).T, (T_ + V @ K).T],
            [jnp.zeros((b * b, b), dt), U.T],
        ])
        w_el = jnp.concatenate([
            q + K.T @ r + 0.5 * (X + Z @ K).T @ vecS,
            p + 0.5 * Y.T @ vecS,
        ])
        return M_el, w_el, K, safe_chol, D, bad

    M_els, w_els, K, chols, Ds, bads = jax.vmap(per_step)(
        cost.Q[:T], cost.q[:T], cost.R[:T], cost.r[:T], cost.P[:T], cost.p[:T],
        dyn.F, dyn.G, dyn.X, dyn.Y, dyn.Z, dyn.T, dyn.U, dyn.V, S[1:],
    )

    # ---- pass 2: joint (s, τ) affine suffix ladder, terminal as (M=0, w=z_T)
    d_dim = b + b * b
    z_T = jnp.concatenate([cost.q[T], cost.p[T]])
    aff = AffineElement(
        M=jnp.concatenate([M_els, jnp.zeros((1, d_dim, d_dim), dt)], axis=0),
        w=jnp.concatenate([w_els, z_T[None]], axis=0),
    )
    if mesh is None:
        z = _affine_suffix(aff)
    else:
        z = _sharded_affine_suffix(aff, mesh, axis_name, T, d_dim, dt)
    s = z[:, :b]
    tau = z[:, b:]

    # ---- feedforward + dS from the landed (s', τ') planes
    def ff(r, G, V, Z, chol_t, D_t, S_n, s_n, tau_n):
        d_vec = r + G.T @ s_n + V.T @ tau_n + 0.5 * Z.T @ S_n.reshape(-1)
        kff_t = -chol_solve(chol_t, d_vec)
        dS_t = jnp.stack([kff_t @ d_vec, 0.5 * kff_t @ D_t @ kff_t])
        return kff_t, dS_t

    kff, dS_t = jax.vmap(ff)(
        cost.r[:T], dyn.G, dyn.V, dyn.Z, chols, Ds, S[1:], s[1:], tau[1:]
    )
    dS = jnp.sum(dS_t, axis=0)

    diverged = (
        jnp.any(bads)
        | ~jnp.all(jnp.isfinite(S))
        | ~jnp.all(jnp.isfinite(z))
        | ~jnp.all(jnp.isfinite(K))
        | ~jnp.all(jnp.isfinite(kff))
    )
    return LinearPolicy(K=K, kff=kff), S, s, tau, dS, diverged


def pbsp_backward(cost, dyn, lmbda: Array | float = 0.0):
    """Single-device parallel-in-time BSP backward (λ-folded) — the local twin
    of :func:`sharded_bsp_backward` and the ``backward='pscan'`` engine of
    :func:`parallel.bsp.make_bsp_solver`."""
    return sharded_bsp_backward(cost, dyn, lmbda, mesh=None)
