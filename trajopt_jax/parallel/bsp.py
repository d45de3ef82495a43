"""Fully-compiled belief-space iLQR and belief-MPC.

The host solver (solvers/bspilqr.BSPiLQR) preserves the reference's per-iteration
host↔device structure (bspilqr/bspilqr.py:126-224); the reference's light-dark MPC
driver additionally re-instantiates that solver at every control step
(examples/bspilqr/lightdark.py:34-45).  Here the entire solve — belief-dynamics
Jacobians, λ-escalated backward pass over the (S, s, τ) belief value, vmapped α-grid
belief rollouts, accept/reject — is one jitted program (:func:`make_bsp_solver`),
and the full EKF-in-the-loop MPC episode is one ``lax.scan``
(:func:`make_bsp_mpc_runner`), vmappable over episode batches
(:func:`run_bsp_mpc_batch`).  :func:`make_bsp_solver_batched` is the
batch-of-problems form: per-instance masked λ escalation around one vmapped
belief backward pass per trial.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..core.belief import (
    belief_cost_expansion,
    belief_dynamics_expansion,
    bsp_backward,
)
from ..core.ekf import EKF, belief_ekf_step
from ..core.types import LinearPolicy
from ..solvers.common import DEFAULT_ALPHAS


class BSPState(NamedTuple):
    bref_mu: Array     # (T+1, b)
    bref_sigma: Array  # (T+1, b, b)
    uref: Array        # (T, du)
    K: Array           # (T, du, b)
    kff: Array         # (T, du)
    lmbda: Array       # ()
    dlmbda: Array      # ()
    last_return: Array # ()
    done: Array        # () bool


def make_bsp_solver(
    env,
    nb_steps: int,
    nb_iter: int = 25,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-8,
    tolgrad: float = 1e-6,
    min_imp: float = 0.0,
    reg: int = 1,
    value_form: str = "dense",
    backward: str = "scan",
    time_mesh=None,
    time_axis: str = "time",
    differentiable: bool = False,
    lm_steps: int = 16,
):
    """Build ``solve(mu0, sigma0, kff_init) -> (state, trace)`` — the BSP-iLQR
    outer loop (bspilqr/bspilqr.py:126-224) as pure ``lax`` control flow, with the
    same λ/α/termination semantics as the host class.

    ``differentiable=True`` makes the whole belief-space solve reverse-
    differentiable (gradients of planned behavior w.r.t. the initial belief
    and environment parameters — e.g. the light-dark noise geometry), the same
    rewrite as ``make_ilqr_solver_batched(differentiable=True)``: the λ
    while_loop becomes a ``lm_steps``-bounded scan whose trips are gated on the
    ORIGINAL loop condition (results identical whenever the while_loop
    terminates within ``lm_steps``), the expected-improvement division is
    guarded against 0/0 in its VJP, and each outer iteration is checkpointed.

    ``value_form`` selects the (S, s, τ) backward recursion: ``"dense"`` mirrors
    bspilqr/src/util.cpp:146-189; ``"sqrt"`` carries the value Hessian as its
    Cholesky factor through QR array updates (core/belief.bsp_backward_sqrt) —
    PSD by construction, the principled f32 form, pairing with
    ``belief_filter="sqrt"`` in :func:`make_bsp_mpc_runner` for a square-root
    end-to-end belief pipeline.

    Backward engines (``value_form='dense'`` only):
      * ``backward='scan'`` (default) — sequential ``lax.scan`` (S, s, τ)
        recursion with the reference's exact reg ∈ {1, 2} LM semantics.
      * ``backward='pscan'`` — parallel-in-time two-ladder pass
        (core/pscan_lqr.sharded_bsp_backward with ``mesh=None``): the S planes
        on the Riccati element ladder, the coupled (s, τ) channel on an affine
        suffix ladder.  λ is folded into the action Hessian (exact at λ = 0,
        proximal variant beyond; ``reg`` is ignored) — the same contract as
        ``make_ilqr_solver(backward='pscan')``.
      * ``time_mesh=Mesh(..., (time_axis,))`` — the same two-ladder pass with
        the horizon block-sharded across the mesh axis and composites exchanged
        via log-depth ``ppermute`` ladders (SURVEY.md §2.4's sequence-parallel
        axis, now covering the belief-space family too)."""
    if time_mesh is not None or backward == "pscan":
        if value_form != "dense":
            raise ValueError(
                "backward='pscan' / time_mesh require value_form='dense'"
            )
        from ..core.pscan_lqr import sharded_bsp_backward

        def backward_fn(cost, dyn, lmbda_v, _reg):
            return sharded_bsp_backward(
                cost, dyn, lmbda_v, time_mesh, time_axis
            )
    elif backward != "scan":
        raise ValueError(f"unknown backward impl {backward!r}")
    elif value_form == "sqrt":
        from ..core.belief import bsp_backward_sqrt as backward_fn
    elif value_form == "dense":
        backward_fn = bsp_backward
    else:
        raise ValueError(f"unknown value_form {value_form!r}")
    alphas = jnp.asarray(alphas)
    T = nb_steps
    db, du = env.belief_dim, env.act_dim

    def expand(bref_mu, bref_sigma, uref):
        dyn = belief_dynamics_expansion(env, bref_mu[:T], bref_sigma[:T], uref)
        cost = belief_cost_expansion(env, bref_mu, bref_sigma, uref)
        return cost, dyn

    def forward_all(K, kff, mu0, sigma0, bref_mu, uref):
        def one(alpha):
            def step(carry, inp):
                mu, sigma = carry
                K_t, kff_t, mu_ref, u_ref = inp
                u = u_ref + alpha * kff_t + K_t @ (mu - mu_ref)
                c = env.cost(mu, sigma, u)
                f, _, phi = belief_ekf_step(env, mu, sigma, u)
                return (f, phi), (mu, sigma, u, c)

            inputs = (K, kff, bref_mu[:T], uref)
            (mu_T, sig_T), (mus, sigmas, us, cs) = lax.scan(
                step, (mu0, sigma0), inputs
            )
            c_T = env.cost(mu_T, sig_T, jnp.zeros(du, mu_T.dtype))
            return (
                jnp.concatenate([mus, mu_T[None]], axis=0),
                jnp.concatenate([sigmas, sig_T[None]], axis=0),
                us,
                jnp.concatenate([cs, c_T[None]], axis=0),
            )

        return jax.vmap(one)(alphas)

    def backward_with_lm(cost, dyn, lmbda0, dlmbda0):
        def cond(carry):
            _, lmbda, _, diverged, first = carry
            return (first | diverged) & (lmbda <= max_lmbda)

        def body(carry):
            _, lmbda, dlmbda, _, _ = carry
            out = backward_fn(cost, dyn, lmbda, reg)
            new_div = out[5]
            dlmbda_n = jnp.where(
                new_div, jnp.maximum(dlmbda * mult_lmbda, mult_lmbda), dlmbda
            )
            lmbda_n = jnp.where(
                new_div, jnp.maximum(lmbda * dlmbda_n, min_lmbda), lmbda
            )
            return out, lmbda_n, dlmbda_n, new_div, jnp.asarray(False)

        dummy = backward_fn(cost, dyn, lmbda0, reg)
        init = (dummy, lmbda0, dlmbda0, jnp.asarray(False), jnp.asarray(True))
        if differentiable:
            # while_loop has no reverse rule: bounded scan, each trip gated on
            # the original condition so extra trips are exact no-ops
            def scan_body(carry, _):
                keep = cond(carry)
                new = body(carry)
                return jax.tree.map(
                    lambda a, b: jnp.where(keep, a, b), new, carry
                ), None

            (out, lmbda, dlmbda, diverged, _), _ = lax.scan(
                scan_body, init, None, length=lm_steps
            )
        else:
            out, lmbda, dlmbda, diverged, _ = lax.while_loop(cond, body, init)
        return out, lmbda, dlmbda, diverged

    def iteration(state: BSPState, _):
        def work(state: BSPState):
            cost, dyn = expand(state.bref_mu, state.bref_sigma, state.uref)
            (lc, S, s, tau, dS, _), lmbda, dlmbda, diverged = backward_with_lm(
                cost, dyn, state.lmbda, state.dlmbda
            )
            backpass_done = ~diverged

            g_norm = jnp.mean(
                jnp.max(jnp.abs(lc.kff) / (jnp.abs(state.uref) + 1.0), axis=0)
            )
            grad_done = (g_norm < tolgrad) & (lmbda < 1e-5)

            mus_all, sigmas_all, us_all, costs_all = forward_all(
                lc.K, lc.kff, state.bref_mu[0], state.bref_sigma[0],
                state.bref_mu, state.uref,
            )
            returns = jnp.sum(costs_all, axis=1)
            dreturns = state.last_return - returns
            expected = -1.0 * alphas * (dS[0] + alphas * dS[1])
            if differentiable:
                # expected == 0 → reject, keeping the division's VJP clear of
                # 0/0 (see parallel/mpc.py differentiable notes)
                safe = jnp.where(expected == 0.0, 1.0, expected)
                imp = jnp.where(expected == 0.0, -jnp.inf, dreturns / safe)
            else:
                imp = dreturns / expected
            ok = (imp > min_imp) & backpass_done & jnp.isfinite(returns)
            accepted = jnp.any(ok)
            idx = jnp.argmax(ok)

            dlmbda_acc = jnp.minimum(dlmbda / mult_lmbda, 1.0 / mult_lmbda)
            lmbda_acc = lmbda * dlmbda_acc * (lmbda > min_lmbda)
            dlmbda_rej = jnp.maximum(dlmbda * mult_lmbda, mult_lmbda)
            lmbda_rej = jnp.maximum(lmbda * dlmbda_rej, min_lmbda)

            take = accepted & ~grad_done
            sel = lambda a, b: jnp.where(take, a, b)
            bref_mu = jnp.where(take, mus_all[idx], state.bref_mu)
            bref_sigma = jnp.where(take, sigmas_all[idx], state.bref_sigma)
            uref = jnp.where(take, us_all[idx], state.uref)
            K = jnp.where(take, lc.K, state.K)
            kff = jnp.where(take, lc.kff, state.kff)
            last_return = sel(returns[idx], state.last_return)

            done = (
                grad_done
                | (take & (dreturns[idx] < tolfun))
                | (~accepted & (lmbda_rej > max_lmbda))
            )
            return BSPState(
                bref_mu=bref_mu, bref_sigma=bref_sigma, uref=uref, K=K, kff=kff,
                lmbda=sel(lmbda_acc, lmbda_rej), dlmbda=sel(dlmbda_acc, dlmbda_rej),
                last_return=last_return, done=done,
            )

        state = lax.cond(state.done, lambda st: st, work, state)
        return state, state.last_return

    def solve(mu0: Array, sigma0: Array, kff_init: Array | None = None):
        kff0 = jnp.zeros((T, du), mu0.dtype) if kff_init is None else kff_init
        K0 = jnp.zeros((T, du, db), mu0.dtype)
        bref_mu0 = jnp.zeros((T + 1, db), mu0.dtype).at[0].set(mu0)

        mus_all, sigmas_all, us_all, costs_all = forward_all(
            K0, kff0, mu0, sigma0, bref_mu0, jnp.zeros((T, du), mu0.dtype)
        )
        finite = jnp.all(mus_all < 1e8, axis=(1, 2))
        idx = jnp.argmax(finite)

        state = BSPState(
            bref_mu=mus_all[idx],
            bref_sigma=sigmas_all[idx],
            uref=us_all[idx],
            K=K0, kff=kff0,
            lmbda=jnp.asarray(lmbda, mu0.dtype),
            dlmbda=jnp.asarray(1.0, mu0.dtype),
            last_return=jnp.sum(costs_all[idx]),
            done=jnp.asarray(False),
        )
        it = jax.checkpoint(iteration) if differentiable else iteration
        state, trace = lax.scan(it, state, None, length=nb_iter)
        return state, trace

    return solve


def make_bsp_solver_batched(
    env,
    nb_steps: int,
    nb_iter: int = 25,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-8,
    tolgrad: float = 1e-6,
    min_imp: float = 0.0,
    reg: int = 1,
    engine: str = "scan",
    mesh=None,
    axis_name: str = "dp",
):
    """Batch-of-problems BSP-iLQR: ``solve(mu0s (N,b), sigma0s (N,b,b)) ->
    (state, trace (nb_iter, N))`` with per-instance iteration semantics
    identical to :func:`make_bsp_solver` (dense value form).

    ``mesh`` block-shards the problem axis (each device escalates λ and
    runs the backward pass on its own shard).

    ``engine='scan'`` (the only engine) vmaps the scan kernel.  The λ
    while-loop carries per-instance (λ, Δλ, diverged) masks — an instance
    whose pass succeeded stops updating, so each instance traces exactly its
    single-problem λ path.
    """
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; available: 'scan'")

    def bw(cost_b, dyn_b, lam_b):
        return jax.vmap(lambda c, d, l: bsp_backward(c, d, l, reg))(
            cost_b, dyn_b, lam_b
        )

    alphas = jnp.asarray(alphas)
    T = nb_steps
    db, du = env.belief_dim, env.act_dim

    def expand(bref_mu, bref_sigma, uref):
        dyn = belief_dynamics_expansion(env, bref_mu[:T], bref_sigma[:T], uref)
        cost = belief_cost_expansion(env, bref_mu, bref_sigma, uref)
        return cost, dyn

    def forward_all(K, kff, mu0, sigma0, bref_mu, uref):
        def one(alpha):
            def step(carry, inp):
                mu, sigma = carry
                K_t, kff_t, mu_ref, u_ref = inp
                u = u_ref + alpha * kff_t + K_t @ (mu - mu_ref)
                c = env.cost(mu, sigma, u)
                f, _, phi = belief_ekf_step(env, mu, sigma, u)
                return (f, phi), (mu, sigma, u, c)

            inputs = (K, kff, bref_mu[:T], uref)
            (mu_T, sig_T), (mus, sigmas, us, cs) = lax.scan(
                step, (mu0, sigma0), inputs
            )
            c_T = env.cost(mu_T, sig_T, jnp.zeros(du, mu_T.dtype))
            return (
                jnp.concatenate([mus, mu_T[None]], axis=0),
                jnp.concatenate([sigmas, sig_T[None]], axis=0),
                us,
                jnp.concatenate([cs, c_T[None]], axis=0),
            )

        return jax.vmap(one)(alphas)

    def backward_with_lm_batched(cost_b, dyn_b, lmbda0, dlmbda0, done):
        """Per-instance λ escalation around the batched backward: the loop runs
        while ANY instance is active; masked updates keep finished instances
        on their accepted (out, λ) exactly as their single-problem while.
        ``done`` (frozen) instances never count as active — their results are
        discarded by the caller's freeze anyway, so re-escalating them would
        only add whole-batch backward launches."""

        def escalate(active_div, lmbda, dlmbda):
            dlmbda_n = jnp.where(
                active_div, jnp.maximum(dlmbda * mult_lmbda, mult_lmbda),
                dlmbda,
            )
            lmbda_n = jnp.where(
                active_div, jnp.maximum(lmbda * dlmbda_n, min_lmbda), lmbda
            )
            return lmbda_n, dlmbda_n

        # first trial at λ0 (the single-problem loop's first trip)
        out = bw(cost_b, dyn_b, lmbda0)
        diverged = out[5] & ~done
        lmbda, dlmbda = escalate(diverged, lmbda0, dlmbda0)

        def cond(carry):
            _, lmbda, _, diverged = carry
            return jnp.any(diverged & (lmbda <= max_lmbda))

        def body(carry):
            out, lmbda, dlmbda, diverged = carry
            active = diverged & (lmbda <= max_lmbda)
            new = bw(cost_b, dyn_b, lmbda)

            def take(old, fresh):
                act = active.reshape((-1,) + (1,) * (fresh.ndim - 1))
                return jnp.where(act, fresh, old)

            out_n = jax.tree.map(take, out, new)
            div_n = jnp.where(active, new[5], diverged)
            lmbda_n, dlmbda_n = escalate(active & new[5], lmbda, dlmbda)
            return out_n, lmbda_n, dlmbda_n, div_n

        out, lmbda, dlmbda, diverged = lax.while_loop(
            cond, body, (out, lmbda, dlmbda, diverged)
        )
        return out, lmbda, dlmbda, diverged

    def post(state, lc, dS, lmbda, dlmbda, diverged):
        """Per-instance accept/reject — the tail of make_bsp_solver.iteration,
        vmapped over the batch."""
        backpass_done = ~diverged
        g_norm = jnp.mean(
            jnp.max(jnp.abs(lc.kff) / (jnp.abs(state.uref) + 1.0), axis=0)
        )
        grad_done = (g_norm < tolgrad) & (lmbda < 1e-5)

        mus_all, sigmas_all, us_all, costs_all = forward_all(
            lc.K, lc.kff, state.bref_mu[0], state.bref_sigma[0],
            state.bref_mu, state.uref,
        )
        returns = jnp.sum(costs_all, axis=1)
        dreturns = state.last_return - returns
        expected = -1.0 * alphas * (dS[0] + alphas * dS[1])
        imp = dreturns / expected
        ok = (imp > min_imp) & backpass_done & jnp.isfinite(returns)
        accepted = jnp.any(ok)
        idx = jnp.argmax(ok)

        dlmbda_acc = jnp.minimum(dlmbda / mult_lmbda, 1.0 / mult_lmbda)
        lmbda_acc = lmbda * dlmbda_acc * (lmbda > min_lmbda)
        dlmbda_rej = jnp.maximum(dlmbda * mult_lmbda, mult_lmbda)
        lmbda_rej = jnp.maximum(lmbda * dlmbda_rej, min_lmbda)

        take = accepted & ~grad_done
        sel = lambda a, b: jnp.where(take, a, b)
        new = BSPState(
            bref_mu=jnp.where(take, mus_all[idx], state.bref_mu),
            bref_sigma=jnp.where(take, sigmas_all[idx], state.bref_sigma),
            uref=jnp.where(take, us_all[idx], state.uref),
            K=jnp.where(take, lc.K, state.K),
            kff=jnp.where(take, lc.kff, state.kff),
            lmbda=sel(lmbda_acc, lmbda_rej),
            dlmbda=sel(dlmbda_acc, dlmbda_rej),
            last_return=sel(returns[idx], state.last_return),
            done=(
                grad_done
                | (take & (dreturns[idx] < tolfun))
                | (~accepted & (lmbda_rej > max_lmbda))
            ),
        )
        # frozen instances (done) keep their state — the vmapped analogue of
        # make_bsp_solver's lax.cond(state.done, identity, work)
        return jax.tree.map(
            lambda a, b: jnp.where(state.done, a, b), state, new
        )

    def iteration(state_b, _):
        cost_b, dyn_b = jax.vmap(expand)(
            state_b.bref_mu, state_b.bref_sigma, state_b.uref
        )
        (lc, _, _, _, dS, _), lmbda_b, dlmbda_b, div_b = (
            backward_with_lm_batched(
                cost_b, dyn_b, state_b.lmbda, state_b.dlmbda, state_b.done
            )
        )
        state_b = jax.vmap(post)(state_b, lc, dS, lmbda_b, dlmbda_b, div_b)
        return state_b, state_b.last_return

    def solve(mu0s: Array, sigma0s: Array, kff_inits: Array | None = None):
        N = mu0s.shape[0]
        dtype = mu0s.dtype
        kff0 = (
            jnp.zeros((N, T, du), dtype) if kff_inits is None else kff_inits
        )
        K0 = jnp.zeros((N, T, du, db), dtype)

        def init_one(mu0, sigma0, kff0_i, K0_i):
            bref_mu0 = jnp.zeros((T + 1, db), dtype).at[0].set(mu0)
            mus_all, sigmas_all, us_all, costs_all = forward_all(
                K0_i, kff0_i, mu0, sigma0, bref_mu0, jnp.zeros((T, du), dtype)
            )
            finite = jnp.all(mus_all < 1e8, axis=(1, 2))
            idx = jnp.argmax(finite)
            return BSPState(
                bref_mu=mus_all[idx],
                bref_sigma=sigmas_all[idx],
                uref=us_all[idx],
                K=K0_i, kff=kff0_i,
                lmbda=jnp.asarray(lmbda, dtype),
                dlmbda=jnp.asarray(1.0, dtype),
                last_return=jnp.sum(costs_all[idx]),
                done=jnp.asarray(False),
            )

        state_b = jax.vmap(init_one)(mu0s, sigma0s, kff0, K0)
        state_b, trace = lax.scan(iteration, state_b, None, length=nb_iter)
        return state_b, trace

    if mesh is None:
        return solve

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def solve_two_arg(mu0s, sigma0s):
        return solve(mu0s, sigma0s)

    return shard_map(
        solve_two_arg, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(None, axis_name)),
        # fresh zero carries are replicated and only combine with per-shard
        # data (same relaxation as run_mpc_batch); per-shard λ while-loops run
        # independent trip counts by design
        check_vma=False,
    )


def make_bsp_mpc_runner(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 25,
    belief_filter: str = "joseph",
    engine: str = "scan",
    **bsp_kwargs,
):
    """EKF-in-the-loop belief-MPC as one compiled program — the device-native
    replacement for the reference's light-dark driver
    (examples/bspilqr/lightdark.py:24-45): innovate on a first observation, then at
    every control step replan with BSP-iLQR from the current belief, apply the
    first action on the true noisy system, and fold the new observation in with an
    EKF update.

    ``belief_filter`` selects the in-the-loop state estimator: ``"joseph"`` is the
    dense EKF with Joseph-form updates (reference semantics, core/ekf.py);
    ``"sqrt"`` carries the belief covariance as its Cholesky factor through
    QR-array updates (core/sqrt_ekf.py) — PSD by construction, no jitters, the
    preferred form in f32.  Both return dense covariances to the caller.

    ``engine='scan'`` (the only engine) scans the per-step compiled solver.

    ``run(key, x0) -> (xs, belief_mus, belief_sigmas, us, costs)``.
    """
    if belief_filter not in ("joseph", "sqrt"):
        raise ValueError(f"unknown belief_filter {belief_filter!r}")
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; available: 'scan'")
    solve = make_bsp_solver(env, horizon, nb_iter=nb_iter, **bsp_kwargs)
    du = env.act_dim
    if belief_filter == "sqrt":
        from ..core.sqrt_ekf import SqrtEKF, chol_factor

        filt = SqrtEKF(env)
        enter, leave = chol_factor, lambda L: L @ L.T
    else:
        filt = EKF(env)
        enter = leave = lambda s: s

    def run(key: Array, x0: Array):
        mu0, sigma0 = env.init()
        key, k = jax.random.split(key)
        obs0 = jax.random.multivariate_normal(
            k, env.observe(x0), env.obs_noise(x0)
        ).astype(x0.dtype)
        mu_b, cov_b = filt.innovate(
            jnp.asarray(mu0, x0.dtype),
            enter(jnp.asarray(sigma0, x0.dtype)),
            obs0,
        )

        keys = jax.random.split(key, nb_steps)

        def step(carry, k):
            x, mu_b, cov_b = carry
            sigma_b = leave(cov_b)
            state, _ = solve(mu_b, sigma_b)
            u = state.uref[0]
            c = env.cost(mu_b, sigma_b, u)
            xn, obs = env.step(k, x, u)
            mu_n, cov_n = filt.inference(mu_b, cov_b, u, obs)
            return (xn, mu_n, cov_n), (x, mu_b, sigma_b, u, c)

        (x_T, mu_T, cov_T), (xs, mus, sigmas, us, cs) = lax.scan(
            step, (x0, mu_b, cov_b), keys
        )
        sig_T = leave(cov_T)
        return (
            jnp.concatenate([xs, x_T[None]], axis=0),
            jnp.concatenate([mus, mu_T[None]], axis=0),
            jnp.concatenate([sigmas, sig_T[None]], axis=0),
            us, cs,
        )

    return run


def run_bsp_mpc_batch(
    env,
    key: Array,
    nb_episodes: int,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 25,
    mesh=None,
    axis_name: str = "dp",
    **bsp_kwargs,
):
    """Batch of belief-MPC episodes, vmapped and (optionally) mesh-sharded."""
    run = make_bsp_mpc_runner(env, horizon, nb_steps, nb_iter=nb_iter, **bsp_kwargs)

    keys = jax.random.split(key, nb_episodes)
    x0 = env.reset_state()
    x0s = jnp.tile(x0, (nb_episodes, 1))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P(axis_name))
        keys = jax.device_put(keys, sharding)
        x0s = jax.device_put(x0s, sharding)

    xs, mus, sigmas, us, cs = jax.jit(jax.vmap(run))(keys, x0s)
    return {"x": xs, "mu": mus, "sigma": sigmas, "u": us, "c": cs}
