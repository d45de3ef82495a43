"""Fully-compiled iLQR and batched MPC.

The reference parallelizes MPC by farming whole episodes to joblib worker processes
(examples/ilqr/mpc/pendulum_parallel.py:6-48) and re-instantiates a Python solver at
every control step (examples/ilqr/mpc/pendulum.py:23-29).  Here the *entire* solve —
linearize → λ-escalated backward scan → vmapped α-grid line search → accept/reject —
is one jitted device program (:func:`make_ilqr_solver`), the MPC loop is a
``lax.scan`` over control steps (:func:`make_mpc_runner`), and a batch of MPC
episodes is a ``vmap`` whose batch axis shards across a device mesh
(:func:`run_mpc_batch`) — the data-parallel axis of SURVEY.md §2.4.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from ..core.diff import linearize_dynamics_delta, quadratize_cost_delta
from ..core.scan_lqr import ilqr_backward
from ..core.types import LinearPolicy
from ..solvers.common import DEFAULT_ALPHAS, make_weighting, rollout_tracking


class ILQRIterMetrics(NamedTuple):
    """Per-iteration structured metrics emitted by the compiled solvers when
    ``metrics=True`` — the compiled-side analogue of utils.metrics.MetricsRecorder
    (the reference only prints, mbgps.py:313-317)."""

    ret: Array      # accepted return after this iteration
    lmbda: Array    # LM regularizer after accept/reject
    dlmbda: Array   # LM multiplier state
    done: Array     # convergence flag


class ILQRState(NamedTuple):
    xref: Array         # (T+1, dx)
    uref: Array         # (T, du)
    K: Array            # (T, du, dx)
    kff: Array          # (T, du)
    lmbda: Array        # ()
    dlmbda: Array       # ()
    last_return: Array  # ()
    done: Array         # () bool


def make_ilqr_solver(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    activation: dict | None = None,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-6,
    tolgrad: float = 1e-4,
    min_imp: float = 0.0,
    reg: int = 1,
    backward: str = "scan",
    time_mesh=None,
    time_axis: str = "time",
    metrics: bool = False,
):
    """Build ``solve(x0, uref_init) -> (state, actions, return)`` — the iLQR outer
    loop of ilqr/ilqr.py:136-237 as pure ``lax`` control flow.

    Semantics preserved: λ escalation with bail-out above ``max_lmbda``, first-accept
    backtracking over the α-grid (evaluated in parallel), gradient-norm + tolfun
    termination, λ-zeroing below ``min_lmbda``.

    Backward engines:
      * ``backward='scan'`` (default) — sequential ``lax.scan`` Riccati with the
        reference's exact reg ∈ {1, 2} LM recursion.
      * ``backward='pscan'`` — lane-major ``lax.associative_scan`` parallel-in-time
        Riccati (core/pscan_lqr.py); λ is folded into the action Hessian (exact at
        λ = 0, proximal variant for λ > 0; ``reg`` is ignored).
      * ``time_mesh=Mesh(..., (time_axis,))`` — the same parallel-in-time pass with
        the horizon block-sharded across the mesh axis and the block composites
        exchanged via a log-depth ``ppermute`` ladder (SURVEY.md §2.4's
        sequence-parallel axis, through the public solver API).
    """
    weighting = make_weighting(nb_steps, activation)
    alphas = jnp.asarray(alphas)
    T = nb_steps

    def expand(xref, uref):
        A, B = linearize_dynamics_delta(env.dynamics, xref[:T], uref)
        cost = quadratize_cost_delta(env.cost, xref, uref, weighting)
        return A, B, cost

    if time_mesh is not None:
        from ..core.pscan_lqr import sharded_ilqr_backward

        def bwd(cost, A, B, lmbda):
            ctl, value, dV, div = sharded_ilqr_backward(
                cost, A, B, time_mesh, time_axis, lmbda
            )
            return ctl, value, None, dV, div
    elif backward == "pscan":
        from ..core.pscan_lqr import pilqr_backward_reg

        def bwd(cost, A, B, lmbda):
            ctl, value, dV, div = pilqr_backward_reg(cost, A, B, lmbda)
            return ctl, value, None, dV, div
    elif backward == "scan":

        def bwd(cost, A, B, lmbda):
            return ilqr_backward(cost, A, B, lmbda, reg)
    else:
        raise ValueError(
            f"unknown backward impl {backward!r}; available: 'scan', 'pscan'"
        )

    def forward_all(K, kff, xref, uref):
        ctl = LinearPolicy(K=K, kff=kff)
        return jax.vmap(
            lambda a: rollout_tracking(env, ctl, a, xref[0], xref, uref, weighting)
        )(alphas)

    def backward_with_lm(cost, A, B, lmbda0, dlmbda0):
        """λ-escalation loop (ilqr.py:160-173) as a while_loop."""

        def cond(carry):
            _, lmbda, _, diverged, first = carry
            return (first | diverged) & (lmbda <= max_lmbda)

        def body(carry):
            _, lmbda, dlmbda, diverged, first = carry
            out = bwd(cost, A, B, lmbda)
            new_div = out[4]
            # on divergence, escalate λ for the next trip
            dlmbda_n = jnp.where(new_div, jnp.maximum(dlmbda * mult_lmbda, mult_lmbda), dlmbda)
            lmbda_n = jnp.where(new_div, jnp.maximum(lmbda * dlmbda_n, min_lmbda), lmbda)
            return out, lmbda_n, dlmbda_n, new_div, jnp.asarray(False)

        dummy = bwd(cost, A, B, lmbda0)
        init = (dummy, lmbda0, dlmbda0, jnp.asarray(False), jnp.asarray(True))
        out, lmbda, dlmbda, diverged, _ = lax.while_loop(cond, body, init)
        return out, lmbda, dlmbda, diverged

    def iteration(state: ILQRState, _):
        def work(state: ILQRState):
            A, B, cost = expand(state.xref, state.uref)

            (ctl, value, qvalue, dV, _), lmbda, dlmbda, diverged = backward_with_lm(
                cost, A, B, state.lmbda, state.dlmbda
            )
            backpass_done = ~diverged

            g_norm = jnp.mean(
                jnp.max(jnp.abs(ctl.kff) / (jnp.abs(state.uref) + 1.0), axis=0)
            )
            grad_done = (g_norm < tolgrad) & (lmbda < 1e-5)

            states_all, actions_all, costs_all = forward_all(
                ctl.K, ctl.kff, state.xref, state.uref
            )
            returns = jnp.sum(costs_all, axis=1)
            dreturns = state.last_return - returns
            expected = -1.0 * alphas * (dV[0] + alphas * dV[1])
            imp = dreturns / expected
            ok = (imp >= min_imp) & backpass_done & jnp.isfinite(returns)
            accepted = jnp.any(ok)
            idx = jnp.argmax(ok)  # first acceptable α in grid order

            # accept (ilqr.py:204-223)
            dlmbda_acc = jnp.minimum(dlmbda / mult_lmbda, 1.0 / mult_lmbda)
            lmbda_acc = lmbda * dlmbda_acc * (lmbda > min_lmbda)
            # reject (ilqr.py:224-231)
            dlmbda_rej = jnp.maximum(dlmbda * mult_lmbda, mult_lmbda)
            lmbda_rej = jnp.maximum(lmbda * dlmbda_rej, min_lmbda)

            take = accepted & ~grad_done
            xref = jnp.where(take, states_all[idx], state.xref)
            uref = jnp.where(take, actions_all[idx], state.uref)
            K = jnp.where(take, ctl.K, state.K)
            kff = jnp.where(take, ctl.kff, state.kff)
            last_return = jnp.where(take, returns[idx], state.last_return)

            new_lmbda = jnp.where(take, lmbda_acc, lmbda_rej)
            new_dlmbda = jnp.where(take, dlmbda_acc, dlmbda_rej)

            done = (
                grad_done
                | (take & (dreturns[idx] < tolfun))
                | (~accepted & (lmbda_rej > max_lmbda))
            )
            return ILQRState(
                xref=xref, uref=uref, K=K, kff=kff,
                lmbda=new_lmbda, dlmbda=new_dlmbda,
                last_return=last_return, done=done,
            )

        state = lax.cond(state.done, lambda s: s, work, state)
        out = (
            ILQRIterMetrics(state.last_return, state.lmbda, state.dlmbda, state.done)
            if metrics else state.last_return
        )
        return state, out

    def solve(x0: Array, kff_init: Array | None = None):
        dx, du = env.dm_state, env.dm_act
        xref0 = jnp.zeros((T + 1, dx), x0.dtype).at[0].set(x0)
        kff0 = jnp.zeros((T, du), x0.dtype) if kff_init is None else kff_init
        K0 = jnp.zeros((T, du, dx), x0.dtype)

        # init trajectory: first finite candidate over the α-grid (ilqr.py:139-148)
        states_all, actions_all, costs_all = forward_all(
            K0, kff0, xref0, jnp.zeros((T, du), x0.dtype)
        )
        finite = jnp.all(states_all < 1e8, axis=(1, 2))
        idx = jnp.argmax(finite)

        state = ILQRState(
            xref=states_all[idx],
            uref=actions_all[idx],
            K=K0,
            kff=kff0,
            lmbda=jnp.asarray(lmbda, x0.dtype),
            dlmbda=jnp.asarray(1.0, x0.dtype),
            last_return=jnp.sum(costs_all[idx]),
            done=jnp.asarray(False),
        )
        state, trace = lax.scan(iteration, state, None, length=nb_iter)
        return state, trace

    return solve


def make_ilqr_solver_batched(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    activation: dict | None = None,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-6,
    tolgrad: float = 1e-4,
    min_imp: float = 0.0,
    reg: int = 1,
    backward: str = "scan",
    fast_line_search: bool = False,
    metrics: bool = False,
    rollout: str = "scan",
    differentiable: bool = False,
    lm_steps: int = 16,
    interpret: bool = False,
):
    """Batch-native iLQR: ``solve(x0s (N, dx), kff_init (N, T, du)|None)``.

    ``interpret=True`` runs the Pallas engines through the kernel interpreter
    (CPU testing of the solver-level glue — gain handoff, α selection, λ
    masking).

    Same accept/reject semantics as :func:`make_ilqr_solver`, but the batch axis is
    primal rather than vmapped, so the backward pass can run as ONE kernel over all
    instances.  Engines:

    * ``backward='scan'`` — the vmapped ``lax.scan`` kernel (core/scan_lqr.py).
    * ``backward='pallas'`` — the whole recursion for every instance as one
      Pallas launch (core/pallas_lqr.py, compiled through Triton; GPU, or any
      backend with ``interpret=True``).
    * ``rollout='scan'`` — the vmapped α-grid ``lax.scan`` rollouts.
    * ``rollout='pallas'`` — the line search as two Pallas launches
      (core/pallas_rollout.py): phase A rolls ALL α candidates and emits only
      returns; cheap XLA glue picks the first acceptable α per instance;
      phase B re-rolls the selected candidate.  Requires a tile-protocol env
      (env.supports_tiles, envs/base.py).  With ``backward='pallas'`` the
      packed gains flow from the backward kernel straight into the rollout
      kernels — no relayout between them.

    The per-instance λ-escalation loops become one global ``while_loop`` with masked
    per-instance updates — iterate while any live instance still needs escalation,
    freeze the rest — which is exactly what vmapping a ``while_loop`` lowers to, minus
    the per-instance backward dispatch.

    ``differentiable=True`` makes the ENTIRE solve reverse-differentiable
    (``jax.grad`` through the converged trajectory — inverse optimal control /
    differentiable MPC; see :mod:`trajopt_jax.parallel.diffmpc`), something the
    reference's Python-around-Armadillo loop (ilqr/ilqr.py:136-237) cannot offer.
    Three deviations from the default path, none changing results when the λ
    loop terminates within ``lm_steps`` trips:

    * the λ-escalation ``while_loop`` (no reverse rule in XLA) becomes a
      fixed-length masked ``lax.scan`` of ``lm_steps`` trips — instances whose
      escalation would need more trips stay marked diverged for that iteration
      (the outer accept/reject then escalates λ across iterations, as in the
      reference's bail-out path);
    * each outer iteration is wrapped in ``jax.checkpoint`` so reverse-mode
      memory is O(state), not O(nb_iter · rollouts);
    * the expected-improvement ratio guards its division (``expected == 0`` →
      reject) instead of relying on IEEE ``x/0`` — otherwise the division's
      VJP feeds ``0/0 = nan`` into the return cotangents.

    Requires ``backward='scan'`` and ``rollout='scan'`` (the Pallas kernels
    define no VJP).
    """
    weighting = make_weighting(nb_steps, activation)
    alphas = jnp.asarray(alphas)
    T = nb_steps
    if backward not in ("scan", "pallas"):
        raise ValueError(
            f"unknown backward impl {backward!r}; available: 'scan', 'pallas'"
        )
    if rollout not in ("scan", "pallas"):
        raise ValueError(
            f"unknown rollout impl {rollout!r}; available: 'scan', 'pallas'"
        )
    if differentiable and (backward != "scan" or rollout != "scan"):
        raise ValueError(
            "differentiable=True requires backward='scan' and rollout='scan' "
            "(the Pallas kernels define no VJP)"
        )

    def expand(xref, uref):
        A, B = linearize_dynamics_delta(env.dynamics, xref[:T], uref)
        cost = quadratize_cost_delta(env.cost, xref, uref, weighting)
        return A, B, cost

    def lm_loop(bwd, select, lmbda0, dlmbda0, frozen):
        """Global λ-escalation loop with per-instance masking (cf.
        ilqr.py:160-173).  ``bwd(lmbda) -> (K, kff, dV, diverged)`` in the
        engine's layout; ``select(mask, new, old)`` keeps the new gains of
        the instances still escalating."""

        def active_of(lmbda, diverged, first):
            return (first | diverged) & (lmbda <= max_lmbda) & ~frozen

        def cond(carry):
            _, lmbda, _, diverged, first = carry
            return jnp.any(active_of(lmbda, diverged, first))

        def body(carry):
            (K, kff, dV), lmbda, dlmbda, diverged, first = carry
            active = active_of(lmbda, diverged, first)
            Kn, kffn, dVn, divn = bwd(lmbda)
            K = select(active, Kn, K)
            kff = select(active, kffn, kff)
            dV = jnp.where(active[:, None], dVn, dV)
            new_div = jnp.where(active, divn, diverged)
            esc = active & divn
            dlmbda_n = jnp.where(esc, jnp.maximum(dlmbda * mult_lmbda, mult_lmbda), dlmbda)
            lmbda_n = jnp.where(esc, jnp.maximum(lmbda * dlmbda_n, min_lmbda), lmbda)
            return (K, kff, dV), lmbda_n, dlmbda_n, new_div, jnp.zeros_like(first)

        N = lmbda0.shape[0]
        K0, kff0, dV0, _ = bwd(lmbda0)
        init = ((K0, kff0, dV0), lmbda0, dlmbda0, jnp.zeros(N, bool),
                jnp.ones(N, bool))
        if differentiable:
            # fixed trip count: while_loop has no reverse rule.  Extra trips
            # after every instance settles are masked no-ops, so results are
            # identical to the while_loop whenever it terminates within
            # lm_steps trips.
            (out, lmbda, dlmbda, diverged, _), _ = lax.scan(
                lambda c, _: (body(c), None), init, None, length=lm_steps
            )
        else:
            out, lmbda, dlmbda, diverged, _ = lax.while_loop(cond, body, init)
        return out, lmbda, dlmbda, diverged

    if backward == "pallas":
        from ..core.pallas_lqr import (
            pack_batch,
            pad_batch,
            pallas_ilqr_backward_packed,
            unpack_policy,
        )

        def backward_with_lm(cost, A, B, lmbda0, dlmbda0, frozen):
            """The cost/dynamics stacks are relayouted into the kernel's
            batch-minor layout ONCE per outer iteration, the loop carry stays
            batch-minor, and the gains are unpacked a single time after the
            loop — no per-λ-trip relayout."""
            N = lmbda0.shape[0]
            dx, du = A.shape[-1], B.shape[-1]
            packed = pack_batch(cost, A, B, lmbda0)
            n_pad = packed["lam"].shape[0]

            def bwd(lmbda):
                Kl, kffl, dVl, badl = pallas_ilqr_backward_packed(
                    dict(packed, lam=pad_batch(lmbda, n_pad)), dx, du, reg,
                    interpret=interpret,
                )
                return Kl, kffl, dVl[:, :N].T, badl[:N] > 0

            def select(mask, new, old):
                return jnp.where(pad_batch(mask, n_pad), new, old)

            (Kl, kffl, dV), lmbda, dlmbda, diverged = lm_loop(
                bwd, select, lmbda0, dlmbda0, frozen
            )
            pol = unpack_policy(Kl, kffl, N, dx, du)
            # the batch-minor gains feed the rollout kernels as they are
            return (pol.K, pol.kff, dV), lmbda, dlmbda, diverged, (Kl, kffl)

    else:

        def backward_with_lm(cost, A, B, lmbda0, dlmbda0, frozen):
            def bwd(lmbda):
                def one(c, a, b, l):
                    pol, _, _, dV, div = ilqr_backward(c, a, b, l, reg)
                    return pol.K, pol.kff, dV, div

                return jax.vmap(one)(cost, A, B, lmbda)

            def select(mask, new, old):
                return jnp.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

            out, lmbda, dlmbda, diverged = lm_loop(
                bwd, select, lmbda0, dlmbda0, frozen
            )
            return out, lmbda, dlmbda, diverged, None

    if rollout == "pallas":
        from ..core.pallas_lqr import padded_batch, to_batch_minor
        from ..core.pallas_rollout import (
            pack_rollout,
            pallas_rollout_returns,
            pallas_rollout_selected,
        )

        if not getattr(env, "supports_tiles", False):
            raise ValueError(
                f"rollout='pallas' needs a tile-protocol env (_ode_parts); "
                f"{type(env).__name__} does not define one"
            )
        alphas_t = tuple(float(a) for a in np.asarray(alphas))

        def _pack_for_rollout(packed_gains, K_n, kff_n, xref, uref):
            if packed_gains is None:
                return pack_rollout(K_n, kff_n, xref, uref)
            n_pad = padded_batch(xref.shape[0])
            return {
                "K": packed_gains[0], "kff": packed_gains[1],
                "xref": to_batch_minor(xref[:, :T], n_pad),
                "uref": to_batch_minor(uref, n_pad),
            }

        def _phaseA(pk, N, grid):
            returns, oks = pallas_rollout_returns(
                env, pk, weighting, grid, interpret=interpret
            )
            return returns[:N], oks[:N]

        def pallas_line_search(packed_gains, K_n, kff_n, xref, uref):
            """Phase A (all-α returns); the selection glue happens in the
            caller.  Returns the packed operands phase B reuses."""
            N = xref.shape[0]
            pk = _pack_for_rollout(packed_gains, K_n, kff_n, xref, uref)
            returns, oks = _phaseA(pk, N, alphas_t)
            return pk, returns, oks

        def pallas_line_search_fast(packed_gains, K_n, kff_n, dV,
                                    backpass_done, state):
            """Two-phase line search (the warm-MPC shortcut of
            ``line_search`` on the Pallas path): a 1-candidate phase-A kernel
            rolls only α = alphas[0]; when every live instance accepts it, the
            11-candidate sweep is skipped via a batch-wide ``lax.cond``
            (unused α slots filled with +inf returns, which the
            first-acceptable argmax can never pick)."""
            N = state.lmbda.shape[0]
            nA = alphas.shape[0]
            pk = _pack_for_rollout(
                packed_gains, K_n, kff_n, state.xref, state.uref
            )
            ret1, _ = _phaseA(pk, N, (alphas_t[0],))
            ret1 = ret1[:, 0]
            dret1 = state.last_return - ret1
            exp1 = -1.0 * alphas[0] * (dV[:, 0] + alphas[0] * dV[:, 1])
            imp1 = dret1 / exp1
            ok1 = (imp1 >= min_imp) & backpass_done & jnp.isfinite(ret1)

            def fast(_):
                return jnp.concatenate(
                    [ret1[:, None],
                     jnp.full((N, nA - 1), jnp.inf, ret1.dtype)], axis=1,
                )

            def slow(_):
                return _phaseA(pk, N, alphas_t)[0]

            all_fast = jnp.all(ok1 | state.done)
            return pk, lax.cond(all_fast, fast, slow, None)

        def pallas_select(pk, alpha_sel):
            states, actions, _ = pallas_rollout_selected(
                env, pk, weighting, alpha_sel, interpret=interpret
            )
            return states, actions

    def forward_all(K, kff, xref, uref):
        def one(K1, kff1, xr, ur):
            ctl = LinearPolicy(K=K1, kff=kff1)
            return jax.vmap(
                lambda a: rollout_tracking(env, ctl, a, xr[0], xr, ur, weighting)
            )(alphas)

        return jax.vmap(one)(K, kff, xref, uref)  # each (N, nA, ...)

    def forward_first(K, kff, xref, uref):
        def one(K1, kff1, xr, ur):
            ctl = LinearPolicy(K=K1, kff=kff1)
            return rollout_tracking(env, ctl, alphas[0], xr[0], xr, ur, weighting)

        return jax.vmap(one)(K, kff, xref, uref)  # each (N, ...)

    def line_search(K_n, kff_n, dV, backpass_done, state):
        """Two-phase line search with first-accept semantics preserved EXACTLY:
        the reference walks the α-grid in order and stops at the first
        acceptable candidate (ilqr.py:185-201), and the grid starts at
        α = alphas[0] — so when EVERY live instance accepts the first α, the
        other 10 rollout sweeps can never be selected and are skipped via a
        batch-wide ``lax.cond`` (the dominant cost of an iteration is the
        sequential rollout scan).  If any live instance rejects, the full grid
        is evaluated and the selection logic is byte-for-byte the round-1 path
        (the fast branch fills the unused α slots with +inf cost, which the
        first-acceptable argmax can never pick).

        Opt-in (``fast_line_search=True``): a win when all instances usually
        accept α = alphas[0] — warm-started MPC in steady state, small or
        homogeneous batches — and a measured ~20% LOSS on large diverse
        batches (batch-2048 cartpole bench: 31.8 vs 26.2 ms/iter), where some
        instance rejects nearly every iteration and the wave-1 sweep plus the
        cond just add work."""
        N = state.lmbda.shape[0]
        nA = alphas.shape[0]

        s1, a1, c1 = forward_first(K_n, kff_n, state.xref, state.uref)
        ret1 = jnp.sum(c1, axis=1)
        dret1 = state.last_return - ret1
        exp1 = -1.0 * alphas[0] * (dV[:, 0] + alphas[0] * dV[:, 1])
        if differentiable:  # see the safe division note in ``iteration``
            imp1 = jnp.where(
                exp1 == 0.0, -jnp.inf, dret1 / jnp.where(exp1 == 0.0, 1.0, exp1)
            )
        else:
            imp1 = dret1 / exp1
        ok1 = (imp1 >= min_imp) & backpass_done & jnp.isfinite(ret1)

        def fast(_):
            bc = lambda x: jnp.broadcast_to(x[:, None], (N, nA) + x.shape[1:])
            costs = jnp.concatenate(
                [c1[:, None], jnp.full((N, nA - 1) + c1.shape[1:], jnp.inf,
                                       c1.dtype)],
                axis=1,
            )
            return bc(s1), bc(a1), costs

        def slow(_):
            return forward_all(K_n, kff_n, state.xref, state.uref)

        all_fast = jnp.all(ok1 | state.done)
        return lax.cond(all_fast, fast, slow, None)

    def iteration(state: ILQRState, _):
        N = state.lmbda.shape[0]
        A, B, cost = jax.vmap(expand)(state.xref, state.uref)
        (K_n, kff_n, dV), lmbda, dlmbda, diverged, packed_gains = (
            backward_with_lm(cost, A, B, state.lmbda, state.dlmbda, state.done)
        )
        backpass_done = ~diverged

        g_norm = jnp.mean(
            jnp.max(jnp.abs(kff_n) / (jnp.abs(state.uref) + 1.0), axis=1), axis=-1
        )
        grad_done = (g_norm < tolgrad) & (lmbda < 1e-5)

        if rollout == "pallas":
            if fast_line_search:
                pk, returns = pallas_line_search_fast(
                    packed_gains, K_n, kff_n, dV, backpass_done, state
                )
            else:
                pk, returns, _ = pallas_line_search(
                    packed_gains, K_n, kff_n, state.xref, state.uref
                )
        else:
            if fast_line_search:
                states_all, actions_all, costs_all = line_search(
                    K_n, kff_n, dV, backpass_done, state
                )
            else:
                states_all, actions_all, costs_all = forward_all(
                    K_n, kff_n, state.xref, state.uref
                )
            returns = jnp.sum(costs_all, axis=2)                      # (N, nA)
        dreturns = state.last_return[:, None] - returns
        expected = -1.0 * alphas[None] * (dV[:, :1] + alphas[None] * dV[:, 1:])
        if differentiable:
            # expected == 0 → reject, without the IEEE x/0 the default path
            # relies on: the division's VJP would turn the (zero) cotangent of
            # ``imp`` into 0/0 = nan flowing back into the returns.
            safe = jnp.where(expected == 0.0, 1.0, expected)
            imp = jnp.where(expected == 0.0, -jnp.inf, dreturns / safe)
        else:
            imp = dreturns / expected
        ok = (imp >= min_imp) & backpass_done[:, None] & jnp.isfinite(returns)
        accepted = jnp.any(ok, axis=1)
        idx = jnp.argmax(ok, axis=1)                                  # first acceptable α
        rows = jnp.arange(N)

        dlmbda_acc = jnp.minimum(dlmbda / mult_lmbda, 1.0 / mult_lmbda)
        lmbda_acc = lmbda * dlmbda_acc * (lmbda > min_lmbda)
        dlmbda_rej = jnp.maximum(dlmbda * mult_lmbda, mult_lmbda)
        lmbda_rej = jnp.maximum(lmbda * dlmbda_rej, min_lmbda)

        take = accepted & ~grad_done
        sel = lambda m, a, b: jnp.where(m.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        if rollout == "pallas":
            sel_states, sel_actions = pallas_select(pk, alphas[idx])
            xref = sel(take, sel_states, state.xref)
            uref = sel(take, sel_actions, state.uref)
        else:
            xref = sel(take, states_all[rows, idx], state.xref)
            uref = sel(take, actions_all[rows, idx], state.uref)
        K = sel(take, K_n, state.K)
        kff = sel(take, kff_n, state.kff)
        last_return = jnp.where(take, returns[rows, idx], state.last_return)

        new_lmbda = jnp.where(take, lmbda_acc, lmbda_rej)
        new_dlmbda = jnp.where(take, dlmbda_acc, dlmbda_rej)

        done = (
            grad_done
            | (take & (dreturns[rows, idx] < tolfun))
            | (~accepted & (lmbda_rej > max_lmbda))
        )
        new = ILQRState(
            xref=xref, uref=uref, K=K, kff=kff,
            lmbda=new_lmbda, dlmbda=new_dlmbda,
            last_return=last_return, done=done,
        )
        # per-instance equivalent of lax.cond(done, identity, work)
        merged = jax.tree.map(
            lambda a, b: jnp.where(
                state.done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
            ),
            state, new,
        )
        out = (
            ILQRIterMetrics(merged.last_return, merged.lmbda, merged.dlmbda,
                            merged.done)
            if metrics else merged.last_return
        )
        return merged, out

    def solve(x0s: Array, kff_init: Array | None = None):
        N = x0s.shape[0]
        dx, du = env.dm_state, env.dm_act
        xref0 = jnp.zeros((N, T + 1, dx), x0s.dtype).at[:, 0].set(x0s)
        kff0 = jnp.zeros((N, T, du), x0s.dtype) if kff_init is None else kff_init
        K0 = jnp.zeros((N, T, du, dx), x0s.dtype)
        uref0 = jnp.zeros((N, T, du), x0s.dtype)
        rows = jnp.arange(N)

        if rollout == "pallas":
            pk, rets0, oks0 = pallas_line_search(None, K0, kff0, xref0, uref0)
            idx = jnp.argmax(oks0, axis=1)
            xref_i, uref_i = pallas_select(pk, alphas[idx])
            ret_i = rets0[rows, idx]
        else:
            states_all, actions_all, costs_all = forward_all(
                K0, kff0, xref0, uref0
            )
            finite = jnp.all(states_all < 1e8, axis=(2, 3))
            idx = jnp.argmax(finite, axis=1)
            xref_i = states_all[rows, idx]
            uref_i = actions_all[rows, idx]
            ret_i = jnp.sum(costs_all[rows, idx], axis=1)

        state = ILQRState(
            xref=xref_i,
            uref=uref_i,
            K=K0,
            kff=kff0,
            lmbda=jnp.full((N,), lmbda, x0s.dtype),
            dlmbda=jnp.ones((N,), x0s.dtype),
            last_return=ret_i,
            done=jnp.zeros((N,), bool),
        )
        # checkpoint per iteration in differentiable mode: reverse-mode memory
        # stays O(state) instead of storing every α-grid rollout of every
        # iteration for the backward sweep.
        it = jax.checkpoint(iteration) if differentiable else iteration
        state, trace = lax.scan(it, state, None, length=nb_iter)
        return state, trace

    return solve


def make_mpc_runner(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 10,
    **ilqr_kwargs,
):
    """Receding-horizon MPC driver (examples/ilqr/mpc/pendulum.py:18-31) as one
    jitted program: ``run(key, x0) -> (states, actions, costs)``.

    Each control step re-solves iLQR from the current state (warm-started with the
    previous solution's shifted feedforward) and applies the first action on the
    noisy system.
    """
    solve = make_ilqr_solver(env, horizon, nb_iter=nb_iter, **ilqr_kwargs)
    du = env.dm_act

    def run(key: Array, x0: Array):
        keys = jax.random.split(key, nb_steps)

        def step(carry, k):
            x, kff_warm = carry
            state, _ = solve(x, kff_warm)
            u = state.uref[0]
            c = env.cost(x, u, u, 1.0)
            xn = env.step(k, x, u)
            # shift the solution one step for warm starting
            kff_next = jnp.concatenate(
                [state.uref[1:], jnp.zeros((1, du), x.dtype)], axis=0
            )
            return (xn, kff_next), (x, u, c)

        init = (x0, jnp.zeros((horizon, du), x0.dtype))
        (x_T, _), (xs, us, cs) = lax.scan(step, init, keys)
        return jnp.concatenate([xs, x_T[None]], axis=0), us, cs

    return run


def make_mpc_runner_batched(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 10,
    backward: str = "scan",
    **ilqr_kwargs,
):
    """Batch-native MPC: ``run(keys (N,), x0s (N, dx))`` solves ALL episodes' iLQR
    problems jointly at every control step, so the backward pass is one batched
    kernel call (``backward='pallas'``) instead of N vmapped scans."""
    solve = make_ilqr_solver_batched(
        env, horizon, nb_iter=nb_iter, backward=backward, **ilqr_kwargs
    )
    du = env.dm_act

    def run(keys: Array, x0s: Array):
        N = x0s.shape[0]
        keys_t = jax.vmap(lambda k: jax.random.split(k, nb_steps))(keys)
        keys_t = jnp.swapaxes(keys_t, 0, 1)  # (nb_steps, N)

        def step(carry, ks):
            x, kff_warm = carry
            state, _ = solve(x, kff_warm)
            u = state.uref[:, 0]
            c = jax.vmap(lambda x1, u1: env.cost(x1, u1, u1, 1.0))(x, u)
            xn = jax.vmap(env.step)(ks, x, u)
            kff_next = jnp.concatenate(
                [state.uref[:, 1:], jnp.zeros((N, 1, du), x.dtype)], axis=1
            )
            return (xn, kff_next), (x, u, c)

        init = (x0s, jnp.zeros((N, horizon, du), x0s.dtype))
        (x_T, _), (xs, us, cs) = lax.scan(step, init, keys_t)
        states = jnp.concatenate([jnp.swapaxes(xs, 0, 1), x_T[:, None]], axis=1)
        return states, jnp.swapaxes(us, 0, 1), jnp.swapaxes(cs, 0, 1)

    return run


def run_mpc_batch(
    env,
    key: Array,
    nb_episodes: int,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 10,
    mesh=None,
    axis_name: str = "dp",
    batched: bool = False,
    backward: str = "scan",
    **ilqr_kwargs,
):
    """Batch of MPC episodes, sharded over a mesh axis when given.

    Device-native replacement for the 50-process joblib farm of
    examples/ilqr/mpc/pendulum_parallel.py:40-45: the episode axis becomes a sharded
    batch dimension on one or many devices.  ``batched=False`` vmaps the
    per-instance solver; ``batched=True`` uses the batch-native solver so the
    backward pass runs as one kernel (``backward='pallas'``), with
    ``shard_map`` placing each device's episode shard through its own kernel call.
    """
    keys = jax.random.split(key, nb_episodes)
    x0s = jax.vmap(env.sample_init)(keys)

    if batched:
        run = make_mpc_runner_batched(
            env, horizon, nb_steps, nb_iter=nb_iter, backward=backward, **ilqr_kwargs
        )
    else:
        run_one = make_mpc_runner(env, horizon, nb_steps, nb_iter=nb_iter, **ilqr_kwargs)
        run = jax.vmap(run_one)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P(axis_name))
        keys = jax.device_put(keys, sharding)
        x0s = jax.device_put(x0s, sharding)
        if batched:
            from jax import shard_map

            run = shard_map(
                run, mesh=mesh,
                in_specs=(P(axis_name), P(axis_name)),
                out_specs=(P(axis_name), P(axis_name), P(axis_name)),
                # the solver creates fresh (replicated) zero carries inside scans;
                # they only ever combine with per-shard data, so VMA checking is
                # safely relaxed here
                check_vma=False,
            )

    states, actions, costs = jax.jit(run)(keys, x0s)
    return {"x": states, "u": actions, "c": costs}
