"""Pallas kernels (compiled through Triton) for iLQR rollouts and line search.

GPU counterpart of the iLQR forward pass / backtracking line search
(reference ilqr/ilqr.py:89-102, 185-201; action law ilqr/objects.py:137-139).

Beside the backward pass, an iteration's cost is the line search: 11
α-candidate rollouts of T sequential RK4 steps.  As a ``lax.scan`` that is T
steps of tiny fused ops; here each phase is ONE launch:

* :func:`pallas_rollout_returns` — phase A: all α-candidates advance together,
  streaming the packed ``K/kff/xref/uref`` once and emitting only
  per-candidate returns and finite-flags (the candidates share one read of the
  gain stream);
* :func:`pallas_rollout_selected` — phase B: re-rolls only the per-instance
  selected α (first-acceptable in grid order, chosen by cheap XLA glue
  between the launches) and writes the states/actions that become the next
  reference trajectory.

Each program owns a block of instances; its values are ``(candidates,
block)`` tiles, the time loop runs inside the kernel (``lax.fori_loop``) with
the states carried in registers, and the cost weights are loaded by the block
itself.  Physics runs *inside* the kernel through the tile-level env protocol
(envs/base.py ``_ode_parts``/``features_parts``/``_periodic_parts``): every
state component is one tile, so the per-step action → clip → stage cost → RK4
chain is straight-line elementwise code.  Numerics match
:func:`trajopt_jax.solvers.common.rollout_tracking` (same clipping, same
``u_last`` convention, same terminal cost).

Layout contract: identical to core/pallas_lqr.py — time leading, batch minor,
``(T, e, n_pad)`` streams — so the gains the backward kernel emits feed these
kernels with no relayout in between.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl

from .pallas_lqr import (
    block_of,
    compiler_params,
    from_batch_minor,
    pad_batch,
    padded_batch,
    to_batch_minor,
)

_INF = float("inf")


# --------------------------------------------------------------------------------------
# Tile-level env physics: lists of tiles, one per state/action component.
# --------------------------------------------------------------------------------------


def tile_clip_act(env, u):
    return [
        jnp.clip(u[j], -float(env.umax[j]), float(env.umax[j]))
        for j in range(len(u))
    ]


def tile_clip_state(env, x):
    return [
        xi if float(env.xmax[i]) == _INF
        else jnp.clip(xi, -float(env.xmax[i]), float(env.xmax[i]))
        for i, xi in enumerate(x)
    ]


def tile_dynamics(env, x, u):
    """env.dynamics on tiles: clip action, RK4 over ``_ode_parts``, clip state
    (envs/base.py dynamics; reference pendulum.py:58-76).  Envs marked
    ``rk4_backward_integration`` (Robot, robot.py:62-67) integrate with the
    backward RK4 signs instead."""
    dt = float(env.dt)
    sg = -1.0 if getattr(env, "rk4_backward_integration", False) else 1.0
    u = tile_clip_act(env, u)
    f = env._ode_parts
    n = len(x)
    k1 = f(x, u)
    k2 = f([x[i] + sg * (0.5 * dt) * k1[i] for i in range(n)], u)
    k3 = f([x[i] + sg * (0.5 * dt) * k2[i] for i in range(n)], u)
    k4 = f([x[i] + sg * dt * k3[i] for i in range(n)], u)
    xn = [
        x[i] + sg * (dt / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
        for i in range(n)
    ]
    return tile_clip_state(env, xn)


def tile_cost(env, x, u, u_last, w):
    """env.cost on tiles.  The detached-Jacobian feature linearization of
    envs/base.py:100-113 evaluates to the plain feature cost at the expansion
    point, so the rollout stage cost is exactly
    ``uᵀdiag(uw)u (or slew) + w·(z−g)ᵀdiag(gw)(z−g)`` with z = features(x).
    Envs that override ``cost`` supply the matching ``cost_parts`` twin
    (e.g. Robot's dt-scaled cost, robot.py:70-76)."""
    from ..envs.base import TrajEnv

    if type(env).cost is not TrajEnv.cost:
        return env.cost_parts(x, u, u_last, w)
    uw = tuple(float(v) for v in env.uw)
    if env.slew_rate:
        c = sum(uw[j] * (u[j] - u_last[j]) ** 2 for j in range(len(u)))
    else:
        c = sum(uw[j] * u[j] * u[j] for j in range(len(u)))
    z = env.features_parts(env._periodic_parts(x))
    g = tuple(float(v) for v in env.g)
    gw = tuple(float(v) for v in env.gw)
    return c + w * sum(gw[i] * (z[i] - g[i]) ** 2 for i in range(len(z)))


# --------------------------------------------------------------------------------------
# Kernel body
# --------------------------------------------------------------------------------------


def _step(env, x, uprev, K, kff, xr, ur, alpha, w, dx, du):
    """One tracking-controller step on tiles: u = ur + α·kff + K(x − xr), clipped;
    stage cost with the PREVIOUS action as u_last (the reference passes the
    current one, silently killing slew penalties — noted defect, SURVEY §2.6)."""
    u = [
        ur[j] + alpha * kff[j] + sum(K[j][c] * (x[c] - xr[c]) for c in range(dx))
        for j in range(du)
    ]
    u = tile_clip_act(env, u)
    c_step = tile_cost(env, x, u, uprev, w)
    xn = tile_dynamics(env, x, u)
    return u, c_step, xn


def _blow_up_ok(ok, x):
    # signed < 1e8 like the reference's blow-up check (ilqr.py:141); NaN
    # compares False and clears the flag
    for xc in x:
        ok = jnp.where(xc < 1e8, ok, jnp.zeros_like(ok))
    return ok


def _rollout_kernel(
    k_ref, kff_ref, xref_ref, uref_ref, w_ref, alpha_ref,
    ret_ref, ok_ref, *traj_refs, env, dx, du,
):
    """Roll ``(candidates, block)`` tiles of the tracking controller over the
    whole horizon.  With ``traj_refs = (xs, us, xT)`` (phase B) the states and
    actions are written out too."""
    T = k_ref.shape[0]
    alpha = alpha_ref[...]
    zero = jnp.zeros_like(alpha)

    def row(ref, t, e):
        return ref[t, e][None, :]

    def body(t, carry):
        x, uprev, ret, ok = carry
        K = [[row(k_ref, t, j * dx + c) for c in range(dx)] for j in range(du)]
        kff = [row(kff_ref, t, j) for j in range(du)]
        xr = [row(xref_ref, t, c) for c in range(dx)]
        ur = [row(uref_ref, t, j) for j in range(du)]
        ok = _blow_up_ok(ok, x)
        u, c_step, xn = _step(env, x, uprev, K, kff, xr, ur, alpha, w_ref[t], dx, du)
        if traj_refs:
            xs_ref, us_ref, _ = traj_refs
            for c in range(dx):
                xs_ref[t, c] = x[c]
            for j in range(du):
                us_ref[t, j] = u[j]
        return xn, u, ret + c_step, ok

    x0 = [zero + row(xref_ref, 0, c) for c in range(dx)]
    x, _, ret, ok = lax.fori_loop(
        0, T, body, (x0, [zero] * du, zero, jnp.ones_like(alpha))
    )
    ret_ref[...] = ret + tile_cost(env, x, [zero] * du, [zero] * du, w_ref[T])
    ok_ref[...] = _blow_up_ok(ok, x)
    if traj_refs:
        xT_ref = traj_refs[2]
        for c in range(dx):
            xT_ref[c] = x[c]


# --------------------------------------------------------------------------------------
# Host-side wrappers
# --------------------------------------------------------------------------------------


PackedRollout = dict


def pack_rollout(K: Array, kff: Array, xref: Array, uref: Array) -> PackedRollout:
    """Batch-leading rollout operands → the kernels' batch-minor layout.

    Args: ``K (N, T, du, dx)``, ``kff (N, T, du)``, ``xref (N, T+1, dx)``
    (row 0 is the rollout start state), ``uref (N, T, du)``.
    """
    N, T = K.shape[0], K.shape[1]
    pack = partial(to_batch_minor, n_pad=padded_batch(N))
    return PackedRollout(
        K=pack(K), kff=pack(kff), xref=pack(xref[:, :T]), uref=pack(uref)
    )


def _call(env, packed, weighting, alpha, *, traj, interpret):
    """One launch over a ``(candidates, n_pad)`` α array."""
    dtype = packed["K"].dtype
    T, _, n_pad = packed["K"].shape
    dx = packed["xref"].shape[1]
    du = packed["uref"].shape[1]
    nA = alpha.shape[0]
    blk = block_of(n_pad)

    def tspec(*e):
        return pl.BlockSpec((T, *e, blk), lambda b: (0,) + (0,) * len(e) + (b,))

    def cspec(e):
        return pl.BlockSpec((e, blk), lambda b: (0, b))

    out_specs = [cspec(nA), cspec(nA)]
    out_shape = [jax.ShapeDtypeStruct((nA, n_pad), dtype)] * 2
    if traj:
        out_specs += [tspec(dx, 1), tspec(du, 1),
                      pl.BlockSpec((dx, 1, blk), lambda b: (0, 0, b))]
        out_shape += [
            jax.ShapeDtypeStruct((T, dx, 1, n_pad), dtype),
            jax.ShapeDtypeStruct((T, du, 1, n_pad), dtype),
            jax.ShapeDtypeStruct((dx, 1, n_pad), dtype),
        ]
    return pl.pallas_call(
        partial(_rollout_kernel, env=env, dx=dx, du=du),
        grid=(n_pad // blk,),
        in_specs=[
            tspec(du * dx), tspec(du), tspec(dx), tspec(du),
            pl.BlockSpec((T + 1,), lambda b: (0,)),
            cspec(nA),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=compiler_params(nA * blk),
        interpret=interpret,
        name="rollout_selected" if traj else "rollout_returns",
    )(
        packed["K"], packed["kff"], packed["xref"], packed["uref"],
        jnp.asarray(weighting, dtype)[:T + 1], alpha,
    )


def pallas_rollout_returns(
    env, packed: PackedRollout, weighting: Array, alphas, *, interpret: bool = False
) -> tuple[Array, Array]:
    """Phase A: per-candidate returns for the whole α-grid in ONE launch.

    Returns batch-leading ``(returns (N_pad, nA), ok (N_pad, nA))`` where
    ``ok`` is the reference's states-below-1e8 flag over the whole trajectory
    (ilqr.py:141).  The candidates are padded to a power of two (Triton's
    block rule) by repeating the first one.
    """
    alphas = jnp.asarray(alphas, packed["K"].dtype)
    nA = alphas.shape[0]
    nA_pad = 1 << (nA - 1).bit_length()
    n_pad = packed["K"].shape[-1]
    grid = jnp.concatenate([alphas, jnp.broadcast_to(alphas[:1], (nA_pad - nA,))])
    ret, ok = _call(
        env, packed, weighting, jnp.broadcast_to(grid[:, None], (nA_pad, n_pad)),
        traj=False, interpret=interpret,
    )
    return ret[:nA].T, ok[:nA].T > 0


def pallas_rollout_selected(
    env, packed: PackedRollout, weighting: Array, alpha: Array,
    *, interpret: bool = False,
) -> tuple[Array, Array, Array]:
    """Phase B: roll out the per-instance α ``(N,)``, emitting the accepted
    trajectory.  Returns batch-leading ``(states (N, T+1, dx), actions
    (N, T, du), returns (N,))`` matching ``rollout_tracking``."""
    N = alpha.shape[0]
    n_pad = packed["K"].shape[-1]
    ret, _, xs, us, xT = _call(
        env, packed, weighting, pad_batch(alpha, n_pad)[None],
        traj=True, interpret=interpret,
    )
    dx, du = xs.shape[1], us.shape[1]
    states = from_batch_minor(xs[:, :, 0], N, (dx,))
    xT = from_batch_minor(xT[None, :, 0], N, (dx,))
    actions = from_batch_minor(us[:, :, 0], N, (du,))
    return jnp.concatenate([states, xT], axis=1), actions, ret[0, :N]

