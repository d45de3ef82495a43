"""Batched iLQR backward pass as one Pallas kernel, compiled through Triton.

GPU counterpart of ilqr.core.backward_pass (reference ilqr/src/util.cpp:83-182)
for *batches* of problems — the layout the MPC farms
(examples/ilqr/mpc/pendulum_parallel.py) and the batch-native solvers run.

Why a kernel: the per-timestep blocks are tiny (dx ≤ 8, du ≤ 4) and the
recursion is T-sequential.  As a ``lax.scan`` every timestep is several fusions
plus a batched Cholesky, so one backward pass at T = 1000 is thousands of
launches.  Here the whole recursion is ONE launch:

* the grid runs over blocks of ``block`` instances (a power of two, see
  :func:`batch_block`); the time loop runs inside the kernel as a reversed
  ``lax.fori_loop`` with the value function (V, v) carried in registers;
* operands are batch-minor ``(T, e, n_pad)``: entry ``e`` of one timestep for
  the block's instances is one contiguous, coalesced load, and T never enters
  a block shape (Triton wants power-of-two blocks);
* the small-matrix algebra — products, Cholesky, triangular solves — is
  unrolled at trace time into elementwise vector code over the block's
  instances.  No ``pl.dot`` is used, so no TF32 product enters: every
  operation runs at the operands' own precision.

Numerics match :func:`trajopt_jax.core.scan_lqr.ilqr_backward` (same
regularization modes reg ∈ {1, 2}, same expected-improvement ``dV``, same
divergence semantics: a non-PD ``Quu`` flags the instance and its values carry
safe finite garbage, exactly like the guarded-Cholesky scan path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .types import LinearPolicy, QuadraticCost

_BLOCK_MIN, _BLOCK_MAX = 16, 128
_SMS = 132  # streaming multiprocessors of an H100 SXM


def batch_block(n: int) -> int:
    """Instances per kernel program: the largest power of two in [16, 128]
    that still gives every SM of the card a program, else 16."""
    b = _BLOCK_MAX
    while b > _BLOCK_MIN and -(-n // b) < _SMS:
        b //= 2
    return b


def padded_batch(n: int) -> int:
    """Instance count after padding a batch of ``n`` to whole blocks."""
    b = batch_block(n)
    return -(-n // b) * b


def block_of(n_pad: int) -> int:
    """Block size the kernels use for an already padded batch."""
    b = batch_block(n_pad)
    while n_pad % b:
        b //= 2
    return b


def compiler_params(elems: int) -> plt.CompilerParams:
    """One warp per 32 values of the program's vectors (1 to 8 warps)."""
    return plt.CompilerParams(num_warps=max(1, min(8, elems // 32)), num_stages=1)


# --------------------------------------------------------------------------------------
# Layout: batch-leading (N, T, *dims) ↔ batch-minor (T, e, n_pad)
# --------------------------------------------------------------------------------------


def to_batch_minor(x: Array, n_pad: int) -> Array:
    """(N, T, *dims) → (T, prod(dims), n_pad).  Padding instances replicate
    instance 0, so they stay well-posed (PD) and never flag divergence."""
    N, T = x.shape[0], x.shape[1]
    x = x.reshape(N, T, -1)
    if n_pad > N:
        x = jnp.concatenate([x, jnp.broadcast_to(x[:1], (n_pad - N,) + x.shape[1:])])
    return jnp.transpose(x, (1, 2, 0))


def from_batch_minor(x: Array, N: int, dims: tuple[int, ...]) -> Array:
    """(T, prod(dims), n_pad) → (N, T, *dims)."""
    return jnp.transpose(x[..., :N], (2, 0, 1)).reshape(N, x.shape[0], *dims)


def pad_batch(x: Array, n_pad: int) -> Array:
    """Per-instance values ``(N, ...)`` → ``(n_pad, ...)`` (padding replicates
    instance 0)."""
    N = x.shape[0]
    if n_pad == N:
        return x
    return jnp.concatenate([x, jnp.broadcast_to(x[:1], (n_pad - N,) + x.shape[1:])])


# --------------------------------------------------------------------------------------
# Small-matrix algebra on lists of vectors.
#
# A "matrix" is a list-of-lists of arrays: M[i][j] is the (i, j) entry for every
# instance of the block at once.  Everything below unrolls at trace time
# (dims ≤ 8) into straight-line elementwise code.
# --------------------------------------------------------------------------------------


def _load_mat(ref, t, n, m):
    return [[ref[t, i * m + j] for j in range(m)] for i in range(n)]


def _load_vec(ref, t, n):
    return [ref[t, i] for i in range(n)]


def _t(A):
    return [[A[i][j] for i in range(len(A))] for j in range(len(A[0]))]


def _add(A, B):
    return [[A[i][j] + B[i][j] for j in range(len(A[0]))] for i in range(len(A))]


def _mm(A, B):
    """(n,k) @ (k,m)."""
    n, k, m = len(A), len(B), len(B[0])
    return [
        [sum(A[i][l] * B[l][j] for l in range(k)) for j in range(m)]
        for i in range(n)
    ]


def _mm_tn(A, B):
    """Aᵀ @ B for A:(k,n), B:(k,m)."""
    k, n, m = len(A), len(A[0]), len(B[0])
    return [
        [sum(A[l][i] * B[l][j] for l in range(k)) for j in range(m)]
        for i in range(n)
    ]


def _mv(A, x):
    return [sum(A[i][j] * x[j] for j in range(len(x))) for i in range(len(A))]


def _mv_tn(A, x):
    """Aᵀ x for A:(k,n), x:(k,)."""
    return [sum(A[l][i] * x[l] for l in range(len(A))) for i in range(len(A[0]))]


def _dot(x, y):
    return sum(a * b for a, b in zip(x, y))


def _sym(A):
    n = len(A)
    return [[0.5 * (A[i][j] + A[j][i]) for j in range(n)] for i in range(n)]


def _chol(A):
    """Unrolled Cholesky–Banachiewicz of a symmetric matrix per instance.

    Returns (L, 1/diag(L), bad) where ``bad`` marks instances whose pivot was
    non-positive or non-finite (the C++ ``is_sympd`` break,
    ilqr/src/util.cpp:145-148).  Bad instances continue with a unit pivot so
    downstream arithmetic stays finite — the same contract as the guarded
    solve in scan_lqr.ilqr_backward.
    """
    n = len(A)
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    bad = jnp.zeros_like(A[0][0], dtype=jnp.bool_)
    for j in range(n):
        s = A[j][j] - sum(L[j][k] * L[j][k] for k in range(j))
        ok = (s > 0) & jnp.isfinite(s)
        bad = bad | ~ok
        s = jnp.where(ok, s, jnp.ones_like(s))
        L[j][j] = jnp.sqrt(s)
        inv_d[j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            r = A[i][j] - sum(L[i][k] * L[j][k] for k in range(j))
            L[i][j] = r * inv_d[j]
    return L, inv_d, bad


def _chol_solve_vec(L, inv_d, b):
    """Solve (L Lᵀ) x = b by unrolled forward/back substitution."""
    n = len(b)
    y = [None] * n
    for i in range(n):
        y[i] = (b[i] - sum(L[i][k] * y[k] for k in range(i))) * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum(L[k][i] * x[k] for k in range(i + 1, n))) * inv_d[i]
    return x


def _chol_solve_mat(L, inv_d, B):
    """Solve (L Lᵀ) X = B column by column; B is (n, m)."""
    cols = [
        _chol_solve_vec(L, inv_d, [B[i][j] for i in range(len(B))])
        for j in range(len(B[0]))
    ]
    return [[cols[j][i] for j in range(len(cols))] for i in range(len(B))]


def _upper(V):
    """Row-major upper triangle of a symmetric matrix (the loop carry)."""
    n = len(V)
    return [V[i][j] for i in range(n) for j in range(i, n)]


def _from_upper(u, n):
    idx, k = {}, 0
    for i in range(n):
        for j in range(i, n):
            idx[i, j] = idx[j, i] = k
            k += 1
    return [[u[idx[i, j]] for j in range(n)] for i in range(n)]


# --------------------------------------------------------------------------------------
# Kernel body
# --------------------------------------------------------------------------------------


def _bwd_step(Cxx, cx, Cuu, cu, Cxu, A, B, V, v, dv0, dv1, lam, dx, du, reg):
    """One backward-recursion step on block values (the body of
    ilqr/src/util.cpp:83-182).  Returns the gains, the new value and the
    step's divergence flag."""
    VA = _mm(V, A)
    VB = _mm(V, B)

    Qxx = _add(Cxx, _mm_tn(A, VA))
    Quu = _add(Cuu, _mm_tn(B, VB))
    QuxT = _add(Cxu, _mm_tn(A, VB))      # = Quxᵀ, (dx, du)
    qx = [cx[i_] + s for i_, s in enumerate(_mv_tn(A, v))]
    qu = [cu[i_] + s for i_, s in enumerate(_mv_tn(B, v))]

    if reg == 1:
        # λ on Quu only: the regularized blocks share the unregularized matmuls
        QuxT_r = QuxT
        Quu_r = [row[:] for row in Quu]
        for j_ in range(du):
            Quu_r[j_][j_] = Quu_r[j_][j_] + lam
    else:
        # λ on the value Hessian: V_reg = V + λI ⇒ VB_reg = VB + λB
        VB_r = [[VB[i_][j_] + lam * B[i_][j_] for j_ in range(du)]
                for i_ in range(dx)]
        QuxT_r = _add(Cxu, _mm_tn(A, VB_r))
        Quu_r = _add(Cuu, _mm_tn(B, VB_r))

    L, inv_d, step_bad = _chol(_sym(Quu_r))

    K = [[-e for e in row] for row in _chol_solve_mat(L, inv_d, _t(QuxT_r))]
    kff = [-e for e in _chol_solve_vec(L, inv_d, qu)]

    Quu_kff = _mv(Quu, kff)
    dv0 = dv0 + _dot(kff, qu)
    dv1 = dv1 + 0.5 * _dot(kff, Quu_kff)

    v = [
        qx[i_] + kquu + kqu + qk
        for i_, (kquu, kqu, qk) in enumerate(
            zip(_mv_tn(K, Quu_kff), _mv_tn(K, qu), _mv(QuxT, kff))
        )
    ]
    M = _sym(_add(Qxx, _mm_tn(K, _mm(Quu, K))))
    P = _mm_tn(K, _t(QuxT))              # Kᵀ Qux, (dx, dx)
    V = [[M[i_][j_] + P[i_][j_] + P[j_][i_] for j_ in range(dx)]
         for i_ in range(dx)]
    return K, kff, V, v, dv0, dv1, step_bad


def _ilqr_kernel(
    cxx_ref, cx_ref, cuu_ref, cu_ref, cxu_ref, a_ref, b_ref,
    vT_ref, vvT_ref, lam_ref,
    k_ref, kff_ref, dv_ref, bad_ref,
    *, dx: int, du: int, reg: int,
):
    T = a_ref.shape[0]
    lam = lam_ref[...]
    zero = jnp.zeros_like(lam)
    V0 = _upper([[vT_ref[i * dx + j] for j in range(dx)] for i in range(dx)])
    v0 = [vvT_ref[i] for i in range(dx)]

    def body(k, carry):
        t = T - 1 - k
        Vu, v, dv0, dv1, bad = carry
        K, kff, V, v, dv0, dv1, step_bad = _bwd_step(
            _load_mat(cxx_ref, t, dx, dx), _load_vec(cx_ref, t, dx),
            _load_mat(cuu_ref, t, du, du), _load_vec(cu_ref, t, du),
            _load_mat(cxu_ref, t, dx, du), _load_mat(a_ref, t, dx, dx),
            _load_mat(b_ref, t, dx, du),
            _from_upper(Vu, dx), v, dv0, dv1, lam, dx, du, reg,
        )
        for i in range(du):
            for j in range(dx):
                k_ref[t, i * dx + j] = K[i][j]
            kff_ref[t, i] = kff[i]
        bad = jnp.where(step_bad, jnp.ones_like(bad), bad)
        return _upper(V), v, dv0, dv1, bad

    _, _, dv0, dv1, bad = lax.fori_loop(0, T, body, (V0, v0, zero, zero, zero))
    dv_ref[0] = dv0
    dv_ref[1] = dv1
    bad_ref[...] = bad


# --------------------------------------------------------------------------------------
# Host-side wrappers: layout transform, padding, pallas_call
# --------------------------------------------------------------------------------------


# A "packed" problem is a plain dict pytree of the kernel's batch-minor operands,
# produced by :func:`pack_batch` and consumed by :func:`pallas_ilqr_backward_packed`.
# Callers that run the backward pass repeatedly on the same linearization (λ loops)
# pack once and skip the relayout on every trial.
PackedLQR = dict


def pack_batch(cost: QuadraticCost, A: Array, B: Array, lmbda: Array) -> PackedLQR:
    """Relayout batch-leading operands into the kernel's batch-minor layout.

    Args: ``cost`` stacks ``Cxx (N, T+1, dx, dx)`` … (slice ``T`` is the
    terminal cost), ``A (N, T, dx, dx)``, ``B (N, T, dx, du)``, ``lmbda (N,)``.
    """
    N, T = A.shape[0], A.shape[1]
    n_pad = padded_batch(N)
    pack = partial(to_batch_minor, n_pad=n_pad)
    return PackedLQR(
        cxx=pack(cost.Cxx[:, :T]), cx=pack(cost.cx[:, :T]),
        cuu=pack(cost.Cuu[:, :T]), cu=pack(cost.cu[:, :T]),
        cxu=pack(cost.Cxu[:, :T]), A=pack(A), B=pack(B),
        vT=pack(cost.Cxx[:, T:])[0],    # (dx*dx, n_pad) terminal value
        vvT=pack(cost.cx[:, T:])[0],    # (dx, n_pad)
        lam=pad_batch(lmbda, n_pad),    # (n_pad,)
    )


def unpack_policy(K: Array, kff: Array, N: int, dx: int, du: int) -> LinearPolicy:
    """Batch-minor kernel gains → batch-leading ``LinearPolicy``."""
    return LinearPolicy(
        K=from_batch_minor(K, N, (du, dx)), kff=from_batch_minor(kff, N, (du,))
    )


def pallas_ilqr_backward_packed(
    packed: PackedLQR, dx: int, du: int, reg: int = 1, *, interpret: bool = False
) -> tuple[Array, Array, Array, Array]:
    """Run the kernel on packed operands, returning batch-minor outputs
    ``(K (T, du*dx, n_pad), kff (T, du, n_pad), dV (2, n_pad), bad (n_pad,))``
    — no relayout on either side (``bad`` is 1.0 where the pass diverged)."""
    T, _, n_pad = packed["A"].shape
    dtype = packed["A"].dtype
    blk = block_of(n_pad)

    def tspec(e):
        return pl.BlockSpec((T, e, blk), lambda b: (0, 0, b))

    def cspec(e):
        return pl.BlockSpec((e, blk), lambda b: (0, b))

    vspec = pl.BlockSpec((blk,), lambda b: (b,))

    return pl.pallas_call(
        partial(_ilqr_kernel, dx=dx, du=du, reg=reg),
        grid=(n_pad // blk,),
        in_specs=[
            tspec(dx * dx), tspec(dx), tspec(du * du), tspec(du), tspec(dx * du),
            tspec(dx * dx), tspec(dx * du), cspec(dx * dx), cspec(dx), vspec,
        ],
        out_specs=[tspec(du * dx), tspec(du), cspec(2), vspec],
        out_shape=[
            jax.ShapeDtypeStruct((T, du * dx, n_pad), dtype),
            jax.ShapeDtypeStruct((T, du, n_pad), dtype),
            jax.ShapeDtypeStruct((2, n_pad), dtype),
            jax.ShapeDtypeStruct((n_pad,), dtype),
        ],
        backend="triton",
        compiler_params=compiler_params(blk),
        interpret=interpret,
        name="ilqr_backward",
    )(
        packed["cxx"], packed["cx"], packed["cuu"], packed["cu"], packed["cxu"],
        packed["A"], packed["B"], packed["vT"], packed["vvT"], packed["lam"],
    )


def pallas_ilqr_backward(
    cost: QuadraticCost,
    A: Array,
    B: Array,
    lmbda: Array,
    reg: int = 1,
    *,
    interpret: bool = False,
) -> tuple[LinearPolicy, Array, Array]:
    """Batched regularized iLQR backward pass as one Pallas launch.

    Args:
      cost: batch-leading stacks — ``Cxx (N, T+1, dx, dx)`` … (delta convention,
        ilqr/objects.py:52-78); slice ``T`` is the terminal cost.
      A, B: linearized dynamics, ``(N, T, dx, dx)`` / ``(N, T, dx, du)``.
      lmbda: per-instance Levenberg–Marquardt λ, shape ``(N,)``.
      reg: 1 → λ on Quu, 2 → λ on the value Hessian (ilqr/src/util.cpp:103-117).

    Returns:
      (policy with ``K (N, T, du, dx)``, ``kff (N, T, du)``;
       dV ``(N, 2)`` expected-improvement pair; diverged ``(N,)`` bool) —
      the same contract as ``jax.vmap(scan_lqr.ilqr_backward)`` restricted to
      the outputs the compiled solver consumes.
    """
    N = A.shape[0]
    dx, du = A.shape[-1], B.shape[-1]
    K, kff, dV, bad = pallas_ilqr_backward_packed(
        pack_batch(cost, A, B, lmbda), dx, du, reg, interpret=interpret
    )
    return unpack_policy(K, kff, N, dx, du), dV[:, :N].T, bad[:N] > 0


# --------------------------------------------------------------------------------------
# Riccati (absolute convention) via homogeneous-coordinate reduction
# --------------------------------------------------------------------------------------


def _augment_riccati(cost: QuadraticCost, A: Array, B: Array, c: Array):
    """Reduce the absolute-convention affine LQR (riccati/riccati.py:100-126) to
    the delta-convention pure-quadratic problem the iLQR kernel solves, via
    homogeneous coordinates z = [x; 1]:

        z' = [[A, c], [0, 1]] z + [B; 0] u,
        stage cost  zᵀ [[Cxx, cx/2], [cxᵀ/2, c0]] z + uᵀ Cuu u + 2 zᵀ [[Cxu], [cuᵀ/2]] u.

    The kernel's recursion on these matrices reproduces the reference recursion
    exactly — e.g. its Qux last column is ½(cu + 2BᵀVc + Bᵀv) = ½qu, so the
    feedforward appears as the gain's last column with the reference's
    ``kff = −½Quu⁻¹qu`` factor built in.  The kernel's own linear channels
    (cx, cu) stay zero."""
    N, T = A.shape[0], A.shape[1]
    dx, du = A.shape[-1], B.shape[-1]
    dtype = A.dtype

    bot = jnp.zeros((N, T, 1, dx + 1), dtype).at[..., 0, dx].set(1.0)
    A_aug = jnp.concatenate(
        [jnp.concatenate([A, c[..., None]], axis=-1), bot], axis=-2
    )
    B_aug = jnp.concatenate([B, jnp.zeros((N, T, 1, du), dtype)], axis=-2)

    top = jnp.concatenate([cost.Cxx, 0.5 * cost.cx[..., None]], axis=-1)
    low = jnp.concatenate(
        [0.5 * cost.cx[..., None, :], cost.c0[..., None, None]], axis=-1
    )
    Cxx_aug = jnp.concatenate([top, low], axis=-2)
    Cxu_aug = jnp.concatenate([cost.Cxu, 0.5 * cost.cu[..., None, :]], axis=-2)

    zeros_x = jnp.zeros((N, T + 1, dx + 1), dtype)
    zeros_u = jnp.zeros((N, T + 1, du), dtype)
    cost_aug = QuadraticCost(
        Cxx=Cxx_aug, cx=zeros_x, Cuu=cost.Cuu, cu=zeros_u, Cxu=Cxu_aug,
        c0=jnp.zeros((N, T + 1), dtype),
    )
    return cost_aug, A_aug, B_aug


def pallas_riccati_backward(
    cost: QuadraticCost,
    A: Array,
    B: Array,
    c: Array,
    *,
    interpret: bool = False,
) -> tuple[LinearPolicy, Array]:
    """Batched exact-LQR (Riccati) backward pass on the Pallas kernel — the
    absolute-convention counterpart of :func:`pallas_ilqr_backward` via
    :func:`_augment_riccati`.  Batch-leading args (``c`` is the dynamics
    residual, (N, T, dx)); returns (policy(K (N,T,du,dx), kff (N,T,du)),
    diverged (N,))."""
    dx = A.shape[-1]
    cost_aug, A_aug, B_aug = _augment_riccati(cost, A, B, c)
    lam = jnp.zeros(A.shape[0], A.dtype)
    pol, _, div = pallas_ilqr_backward(
        cost_aug, A_aug, B_aug, lam, 1, interpret=interpret
    )
    return LinearPolicy(K=pol.K[..., :dx], kff=pol.K[..., dx]), div
