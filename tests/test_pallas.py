"""Parity tests for the Pallas batched iLQR backward pass (core/pallas_lqr.py)
against the lax.scan kernel (core/scan_lqr.ilqr_backward), which is itself
oracle-tested against a NumPy replica of ilqr/src/util.cpp:83-182.

Runs in Pallas interpreter mode on the CPU test backend (float64); the GPU
compiles the same traced kernel through Triton.  The lowering to Triton IR is
checked here too (``lowering_platforms=("cuda",)``); only the Triton compiler
itself needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajopt_jax.core.pallas_lqr import (
    batch_block,
    block_of,
    pad_batch,
    padded_batch,
    pallas_ilqr_backward,
)
from trajopt_jax.core.scan_lqr import ilqr_backward
from trajopt_jax.core.types import QuadraticCost


def _random_problem(key, N, T, dx, du, scale=1.0):
    ks = jax.random.split(key, 8)

    def spd(k, d, n):
        M = jax.random.normal(k, (N, n, d, d))
        return jnp.einsum("bnij,bnkj->bnik", M, M) + d * jnp.eye(d)

    cost = QuadraticCost(
        Cxx=spd(ks[0], dx, T + 1),
        cx=jax.random.normal(ks[1], (N, T + 1, dx)),
        Cuu=spd(ks[2], du, T + 1),
        cu=jax.random.normal(ks[3], (N, T + 1, du)),
        Cxu=0.1 * jax.random.normal(ks[4], (N, T + 1, dx, du)),
        c0=jnp.zeros((N, T + 1)),
    )
    A = scale * (jnp.eye(dx) + 0.05 * jax.random.normal(ks[5], (N, T, dx, dx)))
    B = 0.1 * jax.random.normal(ks[6], (N, T, dx, du))
    lmbda = jax.random.uniform(ks[7], (N,), minval=0.0, maxval=2.0)
    return cost, A, B, lmbda


def _reference(cost, A, B, lmbda, reg):
    def one(c, a, b, l):
        pol, _, _, dV, div = ilqr_backward(c, a, b, l, reg)
        return pol.K, pol.kff, dV, div

    return jax.vmap(one)(cost, A, B, lmbda)


# The interpreter traces the unrolled body op by op, so its cost grows ~dx³;
# the horizon stays short.
@pytest.mark.parametrize("reg", [1, 2])
@pytest.mark.parametrize("dims", [(2, 1), (4, 1), (4, 2), (6, 2), (8, 4)])
def test_matches_scan_kernel(reg, dims):
    dx, du = dims
    N, T = 5, 7  # N deliberately not a multiple of the block
    cost, A, B, lmbda = _random_problem(jax.random.PRNGKey(reg * 10 + dx), N, T, dx, du)

    K_ref, kff_ref, dV_ref, div_ref = _reference(cost, A, B, lmbda, reg)
    pol, dV, div = pallas_ilqr_backward(cost, A, B, lmbda, reg, interpret=True)

    assert not np.any(div_ref)
    np.testing.assert_allclose(pol.K, K_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(pol.kff, kff_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(dV, dV_ref, rtol=1e-8, atol=1e-8)
    assert not np.any(div)


@pytest.mark.parametrize("N", [1, 37, 130])
def test_ragged_batches(N):
    """Batches that fill no whole block are padded to one (padding instances
    replicate instance 0) and cut back on the way out."""
    dx, du, T = 2, 1, 5
    cost, A, B, lmbda = _random_problem(jax.random.PRNGKey(N), N, T, dx, du)
    K_ref, kff_ref, dV_ref, _ = _reference(cost, A, B, lmbda, 1)
    pol, dV, div = pallas_ilqr_backward(cost, A, B, lmbda, 1, interpret=True)
    assert pol.K.shape == (N, T, du, dx) and dV.shape == (N, 2)
    assert div.shape == (N,) and not np.any(div)
    np.testing.assert_allclose(pol.K, K_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(pol.kff, kff_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(dV, dV_ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize(
    "N,block,n_pad",
    [(1, 16, 16), (37, 16, 48), (2048, 16, 2048), (4224, 32, 4224),
     (16384, 64, 16384), (100000, 128, 100096)],
)
def test_batch_block_choice(N, block, n_pad):
    """Power-of-two blocks of 16..128 instances, as large as still gives each
    of the card's 132 SMs a program; padding is to whole blocks."""
    assert batch_block(N) == block
    assert padded_batch(N) == n_pad
    assert block_of(n_pad) == block and n_pad % block == 0
    x = jnp.arange(N, dtype=jnp.float64)
    padded = pad_batch(x, n_pad)
    assert padded.shape == (n_pad,)
    assert np.all(np.asarray(padded[N:]) == 0.0)


def test_divergence_flagged_per_instance():
    dx, du = 4, 2
    N, T = 4, 12
    cost, A, B, lmbda = _random_problem(jax.random.PRNGKey(0), N, T, dx, du)
    # make instance 2 indefinite at one interior step with λ = 0
    Cuu = cost.Cuu.at[2, 5].set(-10.0 * jnp.eye(du))
    cost = cost._replace(Cuu=Cuu)
    lmbda = jnp.zeros((N,))

    pol, dV, div = pallas_ilqr_backward(cost, A, B, lmbda, 1, interpret=True)

    assert bool(div[2])
    assert not np.any(np.delete(np.asarray(div), 2))
    # healthy instances are unaffected by the poisoned lane
    K_ref, kff_ref, dV_ref, _ = _reference(cost, A, B, lmbda, 1)
    for i in [0, 1, 3]:
        np.testing.assert_allclose(pol.K[i], K_ref[i], rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(dV[i], dV_ref[i], rtol=1e-8, atol=1e-8)


def test_packed_path_matches_unpacked():
    """pack_batch → pallas_ilqr_backward_packed → unpack_policy reproduces the
    one-shot wrapper exactly (same kernel, relayout factored out)."""
    from trajopt_jax.core.pallas_lqr import (
        pack_batch,
        pallas_ilqr_backward_packed,
        unpack_policy,
    )

    N, T, dx, du = 3, 7, 4, 2
    cost, A, B, lmbda = _random_problem(jax.random.PRNGKey(11), N, T, dx, du)
    cost, A, B, lmbda = jax.tree.map(
        lambda x: x.astype(jnp.float32), (cost, A, B, lmbda)
    )

    pol, dV, bad = pallas_ilqr_backward(
        cost, A, B, lmbda, reg=1, interpret=True
    )
    K, kff, dVl, badl = pallas_ilqr_backward_packed(
        pack_batch(cost, A, B, lmbda), dx, du, reg=1, interpret=True
    )
    pol2 = unpack_policy(K, kff, N, dx, du)
    dV2, bad2 = dVl[:, :N].T, badl[:N] > 0

    assert np.array_equal(np.asarray(pol.K), np.asarray(pol2.K))
    assert np.array_equal(np.asarray(pol.kff), np.asarray(pol2.kff))
    assert np.array_equal(np.asarray(dV), np.asarray(dV2))
    assert np.array_equal(np.asarray(bad), np.asarray(bad2))


@pytest.mark.parametrize("N,T,dx,du", [(3, 9, 3, 2), (20, 6, 4, 1)])
def test_pallas_riccati_matches_scan(N, T, dx, du):
    """Homogeneous-coordinate reduction: the Pallas Riccati (absolute
    convention, affine dynamics) must match the scan kernel — feedforward
    (kff = -1/2 Quu^-1 qu) included."""
    from trajopt_jax.core.pallas_lqr import pallas_riccati_backward
    from trajopt_jax.core.scan_lqr import riccati_backward
    from trajopt_jax.core.types import LinearDynamics

    from ref_impl import random_quadratic_problem

    rng = np.random.default_rng(900 + N)
    probs = [random_quadratic_problem(rng, T, dx=dx, du=du) for _ in range(N)]
    stack = lambda k: jnp.asarray(np.stack([p[k] for p in probs]))
    cost = QuadraticCost(Cxx=stack("Cxx"), cx=stack("cx"), Cuu=stack("Cuu"),
                         cu=stack("cu"), Cxu=stack("Cxu"), c0=stack("c0"))
    A, B, c = stack("A"), stack("B"), stack("c")

    def one(cost_i, A_i, B_i, c_i):
        ctl, _ = riccati_backward(cost_i, LinearDynamics(A=A_i, B=B_i, c=c_i))
        return ctl.K, ctl.kff

    K_ref, kff_ref = jax.vmap(one)(cost, A, B, c)
    pol, div = pallas_riccati_backward(cost, A, B, c, interpret=True)
    assert not np.any(np.asarray(div))
    np.testing.assert_allclose(np.asarray(pol.K), np.asarray(K_ref),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(pol.kff), np.asarray(kff_ref),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("dims", [(4, 1), (8, 4)])
def test_backward_lowers_to_triton(dims):
    """The kernel lowers to Triton IR for the GPU (Pallas-level lowering faults
    — unsupported primitives, non-power-of-two values — show up here)."""
    dx, du = dims
    with jax.enable_x64(False):
        cost, A, B, lmbda = jax.tree.map(
            lambda x: x.astype(jnp.float32),
            _random_problem(jax.random.PRNGKey(0), 40, 6, dx, du),
        )
        lowered = jax.jit(
            lambda c, a, b, l: pallas_ilqr_backward(c, a, b, l, 1)
        ).trace(cost, A, B, lmbda).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in lowered.as_text()
