"""Fully-compiled distributionally-robust GPS (LRGPS / MBRGPS variants).

The host solvers (solvers/rgps.py) keep the reference's host-driven duals: a
Python geometric bisection on the adversary dual β (mbrgps.py:419-451) and scipy
L-BFGS-B on the policy dual α (mbrgps.py:688-692), each driving jitted device
chains.  Both duals are 1-D with monotone constraint functions, so the whole
min-max alternation compiles:

* **adversary** — the reference's own geometric β-bisection becomes a fixed-length
  ``lax.scan`` with masked best/termination tracking (diverged or non-finite dual
  evaluations mean "β too small", exactly the reference's NaN branch,
  mbrgps.py:440-449); each evaluation runs the adversary fixed point (parameter
  backward pass ∘ cubature forward pass with KL-geodesic damping) as the same
  ``lax.while_loop`` the host uses.
* **policy** — the L-BFGS-B dual reduces to root-finding Σ_t KL(π‖π_old) =
  policy_kl_bound, a log-α bisection as in parallel/gps.py.  Under
  ``policy_kl_stepwise=True`` the T per-timestep constraints KL_t = bound
  (the host's vector L-BFGS-B dual, mbrgps.py:678-702) are solved by the same
  damped multiplicative log-α fixed point as ``parallel/gps.py``'s stepwise
  dual — ``log α_t += γ·log₁₀(KL_t/bound)`` — whose unique fixed point is the
  dual stationarity system.
* the outer alternation (adversary → policy → KL acceptance → refresh) is one
  ``lax.scan``: a full robust-GPS solve per XLA program, vmappable over seeds /
  initial states — the robust analogue of the compiled GPS farms.

``iterative_adversary=True`` compiles the regularized adversary
(``reguarlized_parameter_optimization``, mbrgps.py:633-676) as masked
fixed-length scans: small-KL η-bisected steps anchored at the last accepted
iterate until the total KL-to-nominal budget is spent.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from ..core.cubature import (
    cubature_forward_pass,
    parameter_augment_cost,
    parameter_backward_pass,
    policy_backward_pass,
)
from ..core.diff import evaluate_quadratic_cost, quadratize_cost_abs
from ..core.ekf import extended_kalman
from ..core.scan_lqr import (
    augment_cost_kl,
    gaussian_interp_kl,
    gaussian_interp_w2,
    gaussian_kl,
    policy_kl,
)
from ..core.types import (
    GaussianSequence,
    LinearGaussianPolicy,
    MatrixNormalParams,
    vec_from_matrices,
)
from ..solvers.common import make_weighting


class RGPSState(NamedTuple):
    ctl: LinearGaussianPolicy
    xdist: GaussianSequence
    udist: GaussianSequence
    cost: object                # QuadraticCost
    nominal: MatrixNormalParams
    noise: Array                # (T, dx, dx) process noise (learned for 'mf')
    key: Array                  # rollout PRNG key ('mf' only; dummy otherwise)
    last_return: Array
    beta: Array                 # last adversary dual
    alpha: Array                # last policy dual


def make_rgps_solver(
    env,
    nb_steps: int,
    variant: str = "lr",
    nb_iter: int = 10,
    init_action_sigma: float = 1.0,
    policy_kl_bound: float = 0.1,
    policy_kl_stepwise: bool = False,
    param_nominal_kl_bound: float = 100.0,
    nominal_variance: float = 1e-8,
    activation: dict | None = None,
    slew_rate: bool = False,
    action_penalty=None,
    optimize_adversary: bool = True,
    iterative_adversary: bool = False,
    param_regularizer_kl_bound: float = 1.0,
    beta_iters: int = 50,
    beta_search: str = "bisect",
    beta_rounds: int = 3,
    beta_grid: int = 16,
    eta_iters: int = 10,
    reg_steps: int = 20,
    alpha_bisect_iters: int = 64,
    alpha_search: str = "bisect",
    alpha_rounds: int = 5,
    alpha_grid: int = 16,
    fp_iters: int = 100,
    fp_engine: str = "scan",
    interp: str = "kl",
    nb_episodes: int = 25,
    prior: dict | None = None,
    differentiable: bool = False,
):
    """Build ``solve(mu0, sigma0) -> (state, trace)`` — compiled robust GPS.

    ``variant='lr'`` fixes the nominal at the env's analytic linearization
    (rgps/lrgps.py:100-112) and scores iterates by the exact quadratic expectation;
    ``variant='mb'`` relinearizes the nominal along the EKF mean trajectory each
    accepted iteration (rgps/mbrgps.py:747-754) and scores by the propagated mean
    cost; ``variant='mf'`` learns the nominal (a meanfield MatrixNormal posterior
    over θ) and the process noise from sampled rollouts each accepted iteration
    (rgps/mfrgps.py:87, 542-572) — for it, ``solve(mu0, sigma0, key)`` takes the
    rollout PRNG key, consumed only on accepted iterations (the host's sequence).

    ``beta_search`` selects the adversary dual machinery: ``"bisect"`` is the
    host's sequential geometric bisection (``beta_iters`` fixed-point
    evaluations, reference mbrgps.py:419-451); ``"parallel"`` evaluates
    ``beta_grid`` candidates per round through ONE vmapped fixed point and
    shrinks the bracket ``beta_rounds`` times — the candidates run in
    parallel, so the adversary costs ~``beta_rounds`` sequential walls instead
    of ~50 (same 10% acceptance band; the selected β may differ within the
    band).

    ``fp_engine='scan'`` (the only engine) runs the adversary fixed point as
    the per-instance ``lax.while_loop`` over the scan kernels
    (core/cubature.py).

    ``differentiable=True`` makes ``jax.grad`` through the robust solve match
    the true sensitivity (see parallel/diffmpc.py): the adversary fixed-point
    ``while_loop`` becomes an ``fp_iters``-bounded scan gated on the original
    loop condition (exact rewrite; its unrolled derivative converges to the
    implicit fixed-point derivative), and the fine policy α-bisection — whose
    machine-resolution staircase makes plain AD drop dα*/dθ exactly as in
    ``make_mbgps_solver`` — gets the ``custom_vjp`` implicit-function-theorem
    pass on KL(α*) = ε.  The coarse geometric β/η duals terminate inside a 10%
    acceptance band, so their piecewise-constant AD behavior IS the executed
    algorithm's true local derivative and they need no correction.  For
    reverse-mode memory, prefer small ``fp_iters``/``beta_iters`` (each
    adversary probe unrolls the fixed point).
    """
    if variant not in ("lr", "mb", "mf"):
        raise ValueError(f"unknown variant {variant!r}")
    if fp_engine != "scan":
        raise ValueError(f"unknown fp_engine {fp_engine!r}; available: 'scan'")
    if interp not in ("kl", "w2"):
        raise ValueError(f"unknown interp {interp!r} (options: 'kl', 'w2')")
    if beta_search not in ("bisect", "parallel"):
        raise ValueError(f"unknown beta_search {beta_search!r}")
    if alpha_search not in ("bisect", "parallel"):
        raise ValueError(f"unknown alpha_search {alpha_search!r}")

    overrides = {"slew_rate": slew_rate}
    if action_penalty is not None:
        overrides["uw"] = tuple(float(action_penalty) for _ in range(env.dm_act))
    env = env.replace(**overrides)

    T = nb_steps
    dx, du = env.dm_state, env.dm_act
    p = dx * (dx + du + 1)
    weighting = make_weighting(nb_steps, activation)
    noise_fixed = jnp.tile(jnp.asarray(env.sigma), (T, 1, 1))
    prior_dict = {"K": 1e-6, "psi": 1e-8, "nu": 0.1} if prior is None else prior
    LOG_LO, LOG_HI = -16.0, 16.0

    def quadratize(xmu, umu):
        return quadratize_cost_abs(env.cost, xmu, umu, weighting)

    def cubature(ctl, param, mu0, sigma0, noise):
        return cubature_forward_pass(mu0, sigma0, param, noise, ctl)

    # ------------------------------------------------------------- adversary side
    def fixed_point(agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise):
        """The host's _param_fixed_point_impl (mbrgps.py:386-408) verbatim."""
        dummy = MatrixNormalParams(
            mu=jnp.zeros((T, p), mu0.dtype),
            sigma=jnp.tile(jnp.eye(p, dtype=mu0.dtype), (T, 1, 1)),
        )

        def cond(state):
            q, param, value, kl, diverged, it = state
            return (jnp.any(kl > 1e-3)) & (~diverged) & (it < fp_iters)

        def body(state):
            q, _, _, _, _, it = state
            param, value, diverged = parameter_backward_pass(
                q, ctl, noise, cost, agCpp, agcp, beta
            )
            p_xdist, _, _ = cubature(ctl, param, mu0, sigma0, noise)
            kl = gaussian_kl(p_xdist, q)
            # damping geodesic: KL (reference live path) or W2 alternative
            damp = gaussian_interp_w2 if interp == "w2" else gaussian_interp_kl
            q_new = damp(q, p_xdist, 1e-1)
            return (q_new, param, value, kl, diverged, it + 1)

        init = (
            xdist0,
            dummy,
            parameter_backward_pass(xdist0, ctl, noise, cost, agCpp, agcp, beta)[1],
            jnp.full(T + 1, jnp.inf, mu0.dtype),
            jnp.asarray(False),
            jnp.asarray(0),
        )
        if differentiable:
            # while_loop has no reverse rule: bounded scan, trips gated on the
            # original condition so post-convergence trips are exact no-ops
            def scan_body(state, _):
                keep = cond(state)
                new = body(state)
                return jax.tree.map(
                    lambda a, b: jnp.where(keep, a, b), new, state
                ), None

            (q, param, value, kl, diverged, _), _ = lax.scan(
                scan_body, init, None, length=fp_iters
            )
        else:
            q, param, value, kl, diverged, _ = lax.while_loop(cond, body, init)
        return q, param, diverged

    def fixed_point_batched(agCpp, agcp, ctl, cost, xdist0, beta,
                            mu0, sigma0, noise):
        """N-candidate adversary fixed point: ``agCpp (N, T, p, p)``,
        ``agcp (N, T, p)``, ``beta (N,)``; remaining args unbatched (shared
        across candidates): vmaps the per-instance ``while_loop`` (JAX's
        batched-while per-lane freeze semantics)."""
        return jax.vmap(
            lambda aC, ac, b: fixed_point(
                aC, ac, ctl, cost, xdist0, b, mu0, sigma0, noise
            )
        )(agCpp, agcp, beta)

    def nominal_kl(param, nominal):
        return jnp.sum(
            gaussian_kl(
                GaussianSequence(mu=param.mu, sigma=param.sigma),
                GaussianSequence(mu=nominal.mu, sigma=nominal.sigma),
            )
        )

    def adversary(ctl, cost, xdist, nominal, mu0, sigma0, noise):
        """Geometric β-bisection (mbrgps.py:419-451) as a fixed-length scan."""
        bound = param_nominal_kl_bound

        def grad_at(beta):
            """Host-convention dual gradient hg = bound − nom_kl (the host's
            _parameter_dual returns the NEGATED gradient, solvers/rgps.py)."""
            agCpp, agcp, _ = parameter_augment_cost(nominal, beta)
            _, param, diverged = fixed_point(
                agCpp, agcp, ctl, cost, xdist, beta, mu0, sigma0, noise
            )
            hg = bound - nominal_kl(param, nominal)
            bad = diverged | ~jnp.isfinite(hg)
            return hg, bad

        def body(carry, _):
            beta, min_b, max_b, chosen, best_b, best_g, done = carry
            hg, bad = grad_at(beta)
            upd = ~done
            better = upd & ~bad & (hg < best_g)
            best_b = jnp.where(better, beta, best_b)
            best_g = jnp.where(better, hg, best_g)
            hit = upd & ~bad & (jnp.abs(hg) < 0.1 * bound)
            chosen = jnp.where(hit, beta, chosen)
            done = done | hit
            # hg > 0 ⇔ nom_kl < bound ⇔ β too large (mbrgps.py:443-446);
            # a diverged/NaN evaluation means β too small (mbrgps.py:447-449)
            max_b = jnp.where(upd & ~bad & (hg > 0) & ~hit, beta, max_b)
            min_b = jnp.where(upd & (bad | (~bad & (hg <= 0) & ~hit)), beta, min_b)
            beta_n = jnp.where(done, beta, jnp.sqrt(min_b * max_b))
            return (beta_n, min_b, max_b, chosen, best_b, best_g, done), None

        dt = mu0.dtype
        # Upper bracket: the host uses 1e64 (mbrgps.py:423), which overflows a
        # float32 cast; clamp to a dtype-representable bound whose geometric-mean
        # products with min_b = 1e-4 stay finite.
        # compare as Python floats: NEP-50 would cast 1e65 to the array dtype,
        # emitting a spurious overflow warning in f32
        big = 1e64 if float(np.finfo(np.dtype(dt)).max) > 1e65 else 1e30
        init = (
            jnp.asarray(1e16, dt), jnp.asarray(1e-4, dt), jnp.asarray(big, dt),
            jnp.asarray(1e16, dt), jnp.asarray(1e16, dt), jnp.asarray(jnp.inf, dt),
            jnp.asarray(False),
        )
        (beta, _, _, chosen, best_b, _, done), _ = lax.scan(
            body, init, None, length=beta_iters
        )
        beta_star = jnp.where(done, chosen, best_b)

        agCpp, agcp, _ = parameter_augment_cost(nominal, beta_star)
        _, param, _ = fixed_point(
            agCpp, agcp, ctl, cost, xdist, beta_star, mu0, sigma0, noise
        )
        return param, beta_star

    def adversary_parallel(ctl, cost, xdist, nominal, mu0, sigma0, noise):
        """Grid-then-refine β search: every round evaluates ``beta_grid``
        INDEPENDENT candidates through ONE vmapped fixed point (VERDICT r3
        item 3 — the candidates run in parallel, so 16 of them cost about one
        sequential evaluation's wall time), then
        shrinks the geometric bracket to the adjacent sign-change pair.
        Same acceptance band (|hg| < 0.1·bound), same bad-β bracketing rule,
        same best-candidate fallback as the sequential bisection; ~beta_rounds
        fixed-point walls instead of ``beta_iters`` (default 50)."""
        bound = param_nominal_kl_bound
        dt = mu0.dtype

        def grad_batch(betas):
            """All candidates through ONE batched fixed point."""
            agCpp, agcp, _ = jax.vmap(
                lambda b: parameter_augment_cost(nominal, b)
            )(betas)
            _, param, diverged = fixed_point_batched(
                agCpp, agcp, ctl, cost, xdist, betas, mu0, sigma0, noise
            )
            hg = bound - jax.vmap(lambda pm: nominal_kl(pm, nominal))(param)
            bad = diverged | ~jnp.isfinite(hg)
            return hg, bad

        big = 1e64 if float(np.finfo(np.dtype(dt)).max) > 1e65 else 1e30

        def round_(carry, _):
            lo, hi, chosen, best_b, best_g, done = carry
            f = jnp.arange(1, beta_grid + 1, dtype=dt) / (beta_grid + 1)
            betas = lo * (hi / lo) ** f
            hg, bad = grad_batch(betas)
            valid = ~bad

            hgm = jnp.where(valid, hg, jnp.inf)
            i_best = jnp.argmin(hgm)
            better = ~done & valid[i_best] & (hgm[i_best] < best_g)
            best_b = jnp.where(better, betas[i_best], best_b)
            best_g = jnp.where(better, hgm[i_best], best_g)

            hit = valid & (jnp.abs(hg) < 0.1 * bound)
            i_hit = jnp.argmin(jnp.where(hit, jnp.abs(hg), jnp.inf))
            any_hit = jnp.any(hit)
            chosen = jnp.where(~done & any_hit, betas[i_hit], chosen)

            # hg increases with β (nom_kl decreases); bad ⇒ β too small
            too_small = bad | (hg <= 0)
            lo_n = jnp.maximum(jnp.max(jnp.where(too_small, betas, lo)), lo)
            hi_n = jnp.minimum(
                jnp.min(jnp.where(valid & (hg > 0), betas, hi)), hi
            )
            lo_n = jnp.where(done | any_hit, lo, lo_n)
            hi_n = jnp.where(done | any_hit, hi, hi_n)
            done = done | any_hit
            return (lo_n, hi_n, chosen, best_b, best_g, done), None

        init = (
            jnp.asarray(1e-4, dt), jnp.asarray(big, dt),
            jnp.asarray(1e16, dt), jnp.asarray(1e16, dt),
            jnp.asarray(jnp.inf, dt), jnp.asarray(False),
        )
        (_, _, chosen, best_b, _, done), _ = lax.scan(
            round_, init, None, length=beta_rounds
        )
        beta_star = jnp.where(done, chosen, best_b)

        agCpp, agcp, _ = parameter_augment_cost(nominal, beta_star)
        _, param, _ = fixed_point(
            agCpp, agcp, ctl, cost, xdist, beta_star, mu0, sigma0, noise
        )
        return param, beta_star

    def regularized_adversary(ctl, cost, xdist, nominal, mu0, sigma0, noise):
        """Iterated small-KL adversary (mbrgps.py:633-676) as masked fixed-length
        scans.  Each of ``reg_steps`` outer steps runs the host's geometric
        η-bisection (mbrgps.py:500-532) against the per-step regularizer bound
        with the KL penalty anchored at the LAST accepted iterate, then accepts
        the step only if its KL lands in the 10% band; the outer loop masks to
        identity once the total KL-to-nominal budget is spent — the compiled
        mirror of the host's ``while param_nom_kl < bound`` guard loop."""
        reg_bound = param_regularizer_kl_bound
        nom_bound = param_nominal_kl_bound
        dt = mu0.dtype
        # compare as Python floats: NEP-50 would cast 1e65 to the array dtype,
        # emitting a spurious overflow warning in f32
        big = 1e64 if float(np.finfo(np.dtype(dt)).max) > 1e65 else 1e30

        def solve_at(eta, last):
            agCpp, agcp, _ = parameter_augment_cost(last, eta)
            _, param, diverged = fixed_point(
                agCpp, agcp, ctl, cost, xdist, eta, mu0, sigma0, noise
            )
            return param, diverged

        def eta_bisect(last, eta0):
            """One inner bisection: fresh brackets, first probe = carried η."""

            def body(carry, _):
                eta, min_e, max_e, chosen, best_e, best_g, done = carry
                param, diverged = solve_at(eta, last)
                hg = reg_bound - nominal_kl(param, last)
                bad = diverged | ~jnp.isfinite(hg)
                upd = ~done
                better = upd & ~bad & (hg < best_g)
                best_e = jnp.where(better, eta, best_e)
                best_g = jnp.where(better, hg, best_g)
                hit = upd & ~bad & (jnp.abs(hg) < 0.1 * reg_bound)
                chosen = jnp.where(hit, eta, chosen)
                done = done | hit
                max_e = jnp.where(upd & ~bad & (hg > 0) & ~hit, eta, max_e)
                min_e = jnp.where(upd & (bad | (~bad & (hg <= 0) & ~hit)), eta, min_e)
                eta_n = jnp.where(done, eta, jnp.sqrt(min_e) * jnp.sqrt(max_e))
                return (eta_n, min_e, max_e, chosen, best_e, best_g, done), None

            init = (
                eta0, jnp.asarray(1e-4, dt), jnp.asarray(big, dt),
                eta0, eta0, jnp.asarray(jnp.inf, dt), jnp.asarray(False),
            )
            (eta, _, _, chosen, best_e, _, done), _ = lax.scan(
                body, init, None, length=eta_iters
            )
            return jnp.where(done, chosen, best_e)

        def outer(carry, _):
            last, eta, done = carry
            eta_star = eta_bisect(last, eta)
            param, diverged = solve_at(eta_star, last)
            reg_kl = nominal_kl(param, last)
            ok = (
                (~done) & (~diverged)
                & (jnp.abs(reg_kl - reg_bound) < 0.1 * reg_bound)
            )
            last_n = jax.tree.map(lambda a, b: jnp.where(ok, a, b), param, last)
            nom_kl_n = nominal_kl(last_n, nominal)
            done_n = done | (nom_kl_n >= nom_bound)
            return (last_n, eta_star, done_n), None

        init = (nominal, jnp.asarray(1e16, dt), jnp.asarray(False))
        (last, eta, _), _ = lax.scan(outer, init, None, length=reg_steps)
        return last, eta

    # ---------------------------------------------------------------- policy side
    def policy_kl_at(log_alpha, cost, ctl, param, mu0, sigma0, noise):
        """``log_alpha`` is () for the summed dual, (T,) for the stepwise one;
        the returned KL matches (summed scalar vs per-timestep vector)."""
        alpha = jnp.broadcast_to(10.0 ** log_alpha, (T,)).astype(mu0.dtype)
        agcost = augment_cost_kl(cost, ctl, alpha)
        lgc, xvalue, xuvalue, diverged = policy_backward_pass(
            agcost, param, noise, alpha
        )
        xdist, _, _ = cubature(lgc, param, mu0, sigma0, noise)
        klt = policy_kl(lgc, ctl, xdist)
        kl = klt if policy_kl_stepwise else jnp.sum(klt)
        return kl, diverged, lgc

    def _alpha_bisect(cost, ctl, param, mu0, sigma0, noise):
        bound = policy_kl_bound

        if policy_kl_stepwise:
            # the T constraints KL_t(α) = bound are coupled through the value
            # recursion; a damped multiplicative update in log space converges
            # to the L-BFGS-B vector dual's stationarity system (see
            # parallel/gps.bisect_dual, same rationale)
            gamma = 0.5

            def body_sw(la, _):
                kl, diverged, _ = policy_kl_at(
                    la, cost, ctl, param, mu0, sigma0, noise
                )
                step = gamma * jnp.log10(jnp.maximum(kl, 1e-14) / bound)
                la = jnp.clip(
                    jnp.where(diverged, la + 1.0, la + step), LOG_LO, LOG_HI
                )
                return la, None

            la, _ = lax.scan(
                body_sw, jnp.zeros((T,), mu0.dtype), None,
                length=alpha_bisect_iters,
            )
            return la

        dt = mu0.dtype
        if alpha_search == "parallel":
            # K-ary bracket refinement: each round evaluates alpha_grid
            # interior candidates through ONE vmapped dual chain (KL is
            # monotone decreasing in α) — ~alpha_rounds sequential walls
            # instead of alpha_bisect_iters (VERDICT r3 item 3's lever
            # applied to the policy dual)
            def kl_b(la):
                kl, diverged, _ = policy_kl_at(
                    la, cost, ctl, param, mu0, sigma0, noise
                )
                return kl, diverged

            kl_batch = jax.vmap(kl_b)

            def round_(carry, _):
                lo, hi = carry
                f = jnp.arange(1, alpha_grid + 1, dtype=dt) / (alpha_grid + 1)
                las = lo + (hi - lo) * f
                kl, diverged = kl_batch(las)
                too_small = diverged | (kl > bound)
                lo_n = jnp.maximum(jnp.max(jnp.where(too_small, las, lo)), lo)
                hi_n = jnp.minimum(
                    jnp.min(jnp.where(~too_small, las, hi)), hi
                )
                return (lo_n, hi_n), None

            (lo, hi), _ = lax.scan(
                round_, (jnp.asarray(LOG_LO, dt), jnp.asarray(LOG_HI, dt)),
                None, length=alpha_rounds,
            )
            return 0.5 * (lo + hi)

        def body(carry, _):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            kl, diverged, _ = policy_kl_at(mid, cost, ctl, param, mu0, sigma0, noise)
            too_small = diverged | (kl > bound)
            return (jnp.where(too_small, mid, lo), jnp.where(too_small, hi, mid)), None

        (lo, hi), _ = lax.scan(
            body, (jnp.asarray(LOG_LO, dt), jnp.asarray(LOG_HI, dt)),
            None, length=alpha_bisect_iters,
        )
        return 0.5 * (lo + hi)

    if differentiable:
        # the bisection resolves α* to machine precision, so its staircase AD
        # derivative is zero — restore dα*/dθ with the IFT on KL(α*) = ε,
        # exactly as in make_mbgps_solver(differentiable=True)
        def _alpha_residual(la, cost, ctl, param, mu0, sigma0, noise):
            kl, _, _ = policy_kl_at(la, cost, ctl, param, mu0, sigma0, noise)
            return kl - policy_kl_bound

        @jax.custom_vjp
        def alpha_root(cost, ctl, param, mu0, sigma0, noise):
            return _alpha_bisect(cost, ctl, param, mu0, sigma0, noise)

        def _root_fwd(cost, ctl, param, mu0, sigma0, noise):
            la = _alpha_bisect(cost, ctl, param, mu0, sigma0, noise)
            return la, (la, cost, ctl, param, mu0, sigma0, noise)

        if policy_kl_stepwise:

            def _root_bwd(res, la_bar):
                # the T coupled constraints KL_t(α*) = ε: dense (T, T)
                # implicit solve, Cholesky normal equations (no LU),
                # inactive components decoupled to identity (see the stepwise
                # branch of make_mbgps_solver for the derivation)
                la, cost, ctl, param, mu0, sigma0, noise = res
                g0 = _alpha_residual(la, cost, ctl, param, mu0, sigma0, noise)
                J = jax.jacfwd(_alpha_residual)(
                    la, cost, ctl, param, mu0, sigma0, noise
                )
                active = (jnp.abs(g0) < 0.25 * policy_kl_bound) & (
                    jnp.abs(jnp.diagonal(J)) > 1e-30
                )
                eye = jnp.eye(T, dtype=la.dtype)
                J_eff = jnp.where(active[:, None] & active[None, :], J, eye)
                M = J_eff.T
                rhs = -jnp.where(active, la_bar, 0.0)
                G = M.T @ M + 1e-30 * eye
                w = jnp.linalg.cholesky(G)
                w = jax.scipy.linalg.cho_solve((w, True), M.T @ rhs)
                w = jnp.where(active, w, 0.0)
                _, vjp = jax.vjp(
                    lambda c, p_, pa, m, s, n: _alpha_residual(
                        la, c, p_, pa, m, s, n
                    ),
                    cost, ctl, param, mu0, sigma0, noise,
                )
                return vjp(w)

        else:

            def _root_bwd(res, la_bar):
                la, cost, ctl, param, mu0, sigma0, noise = res
                g0, dg_dla = jax.value_and_grad(_alpha_residual)(
                    la, cost, ctl, param, mu0, sigma0, noise
                )
                active = (jnp.abs(g0) < 0.25 * policy_kl_bound) & (
                    jnp.abs(dg_dla) > 1e-30
                )
                w = jnp.where(active, -la_bar / jnp.where(active, dg_dla, 1.0), 0.0)
                _, vjp = jax.vjp(
                    lambda c, p_, pa, m, s, n: _alpha_residual(
                        la, c, p_, pa, m, s, n
                    ),
                    cost, ctl, param, mu0, sigma0, noise,
                )
                return vjp(w)

        alpha_root.defvjp(_root_fwd, _root_bwd)
    else:
        alpha_root = _alpha_bisect

    def policy(ctl, cost, param, mu0, sigma0, noise):
        log_alpha = alpha_root(cost, ctl, param, mu0, sigma0, noise)
        kl, diverged, lgc = policy_kl_at(log_alpha, cost, ctl, param, mu0, sigma0, noise)
        return lgc, kl, diverged, 10.0 ** log_alpha

    # ------------------------------------------------------------------ scoring
    def expected_cost(cost, xdist, udist):
        """Exact quadratic expectation incl. covariance trace terms
        (rgps/objects.py:128-142, stoch=True)."""
        base = evaluate_quadratic_cost(cost, xdist.mu, udist.mu)
        tx = jnp.einsum("tij,tji->", cost.Cxx, xdist.sigma)
        tu = jnp.einsum("tij,tji->", cost.Cuu[: T - 1], udist.sigma[:-1])
        return base + tx + tu

    def sample_and_fit(key, ctl):
        """Rollouts → meanfield MatrixNormal nominal + learned noise + sampled
        mean return + quadratization point (rgps/mfrgps.py:542-580)."""
        from ..solvers.common import rollout_batch
        from .regression import mniw_meanfield_params

        data = rollout_batch(env, ctl, key, weighting, nb_episodes)
        nominal, noise_l = mniw_meanfield_params(
            data["x"], data["u"], data["xn"], prior_dict
        )
        ret = jnp.mean(jnp.sum(data["c"], axis=1))
        return nominal, noise_l, ret

    def propagate(lgc, mu0, sigma0):
        xdist, udist, lgd = extended_kalman(env, lgc, mu0, sigma0)
        u_last = jnp.concatenate([jnp.zeros((1, du), udist.mu.dtype), udist.mu[:-1]])
        costs = jax.vmap(env.cost)(xdist.mu[:T], udist.mu, u_last, weighting[:T])
        c_T = env.cost(
            xdist.mu[T], jnp.zeros(du, udist.mu.dtype),
            jnp.zeros(du, udist.mu.dtype), weighting[T],
        )
        nominal_mu = jax.vmap(vec_from_matrices)(lgd.A, lgd.B, lgd.c)
        return nominal_mu, jnp.sum(costs) + c_T

    # ------------------------------------------------------------------ main loop
    def iteration(state: RGPSState, _):
        mu0, sigma0 = state.xdist.mu[0], state.xdist.sigma[0]

        if optimize_adversary:
            if iterative_adversary:
                adv = regularized_adversary
            elif beta_search == "parallel":
                adv = adversary_parallel
            else:
                adv = adversary
            param, beta = adv(
                state.ctl, state.cost, state.xdist, state.nominal, mu0, sigma0,
                state.noise,
            )
        else:
            param, beta = state.nominal, state.beta

        lgc, kl, diverged, alpha = policy(
            state.ctl, state.cost, param, mu0, sigma0, state.noise
        )
        # acceptance (mbrgps.py:818 via solvers/rgps._policy_kl_ok):
        # kl < 1.25·bound — per timestep under the stepwise dual
        accept = jnp.all(kl < 1.25 * policy_kl_bound) & ~diverged

        noise_n, key_n = state.noise, state.key
        if variant == "mb":
            nominal_mu_n, ret = propagate(lgc, mu0, sigma0)
            nominal_n = MatrixNormalParams(
                mu=nominal_mu_n, sigma=state.nominal.sigma
            )
        elif variant == "mf":
            k_roll, key_n = jax.random.split(state.key)
            nominal_n, noise_n, ret = sample_and_fit(k_roll, lgc)
        else:
            nominal_n = state.nominal
        # cubature under the refreshed model (lrgps.py:529, mfrgps.py:607)
        xdist_n, udist_n, _ = cubature(lgc, param, mu0, sigma0, noise_n)
        if variant == "lr":
            ret = expected_cost(state.cost, xdist_n, udist_n)
        cost_n = quadratize(xdist_n.mu, udist_n.mu)

        sel = lambda a, b: jax.tree.map(lambda x, y: jnp.where(accept, x, y), a, b)
        new = RGPSState(
            ctl=sel(lgc, state.ctl),
            xdist=sel(xdist_n, state.xdist),
            udist=sel(udist_n, state.udist),
            cost=sel(cost_n, state.cost),
            nominal=sel(nominal_n, state.nominal),
            noise=sel(noise_n, state.noise),
            key=sel(key_n, state.key),
            last_return=jnp.where(accept, ret, state.last_return),
            beta=beta,
            alpha=alpha,
        )
        return new, new.last_return

    def solve(mu0: Array, sigma0: Array, key: Array | None = None):
        ctl0 = LinearGaussianPolicy(
            K=jnp.zeros((T, du, dx), mu0.dtype),
            kff=jnp.zeros((T, du), mu0.dtype),
            sigma=jnp.tile(
                init_action_sigma * jnp.eye(du, dtype=mu0.dtype), (T, 1, 1)
            ),
        )
        nominal_sigma = nominal_variance * jnp.tile(
            jnp.eye(p, dtype=mu0.dtype), (T, 1, 1)
        )
        noise0 = noise_fixed.astype(mu0.dtype)
        key0 = jax.random.PRNGKey(0) if key is None else key
        if variant == "lr":
            A, B, c = env._ABc()
            nominal0 = MatrixNormalParams(
                mu=jnp.tile(vec_from_matrices(
                    jnp.asarray(A, mu0.dtype), jnp.asarray(B, mu0.dtype),
                    jnp.asarray(c, mu0.dtype),
                ), (T, 1)),
                sigma=nominal_sigma,
            )
            xdist0, udist0, _ = cubature(ctl0, nominal0, mu0, sigma0, noise0)
            cost0 = quadratize(xdist0.mu, udist0.mu)
            ret0 = expected_cost(cost0, xdist0, udist0)
        elif variant == "mf":
            k_roll, key0 = jax.random.split(key0)
            nominal0, noise0, ret0 = sample_and_fit(k_roll, ctl0)
            nominal0 = nominal0._replace(
                sigma=nominal0.sigma.astype(mu0.dtype)
            )
            xdist0, udist0, _ = cubature(ctl0, nominal0, mu0, sigma0, noise0)
            cost0 = quadratize(xdist0.mu, udist0.mu)
        else:
            nominal_mu0, ret0 = propagate(ctl0, mu0, sigma0)
            nominal0 = MatrixNormalParams(mu=nominal_mu0, sigma=nominal_sigma)
            xdist0, udist0, _ = cubature(ctl0, nominal0, mu0, sigma0, noise0)
            cost0 = quadratize(xdist0.mu, udist0.mu)

        state = RGPSState(
            ctl=ctl0, xdist=xdist0, udist=udist0, cost=cost0, nominal=nominal0,
            noise=noise0, key=key0,
            last_return=ret0,
            beta=jnp.asarray(1e16, mu0.dtype),
            alpha=jnp.full((T,) if policy_kl_stepwise else (), 1e8, mu0.dtype),
        )
        it = jax.checkpoint(iteration) if differentiable else iteration
        state, trace = lax.scan(it, state, None, length=nb_iter)
        return state, jnp.concatenate([ret0[None], trace])

    return solve


def run_rgps_batch(
    env,
    key: Array,
    nb_problems: int,
    nb_steps: int,
    variant: str = "lr",
    nb_iter: int = 5,
    mesh=None,
    axis_name: str = "dp",
    init_spread: float = 0.1,
    **rgps_kwargs,
):
    """Batch of full robust-GPS solves from perturbed initial states, vmapped and
    (optionally) mesh-sharded — SURVEY.md config #5's "batched (R)GPS" axis, the
    robust counterpart of :func:`parallel.gps.run_gps_mpc_batch`.

    Returns {"trace": (N, nb_iter+1) expected-cost traces,
             "K"/"kff"/"sigma": final robust controller stacks}.
    """
    solve = make_rgps_solver(env, nb_steps, variant=variant, nb_iter=nb_iter,
                             **rgps_kwargs)

    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(mu0)
    sigma0 = jnp.asarray(sigma0)
    keys = jax.random.split(key, nb_problems)
    mu0s = mu0 + init_spread * jax.vmap(
        lambda k: jax.random.normal(k, mu0.shape, mu0.dtype)
    )(keys)
    sigma0s = jnp.tile(sigma0, (nb_problems,) + (1,) * sigma0.ndim)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P(axis_name))
        keys = jax.device_put(keys, sharding)
        mu0s = jax.device_put(mu0s, sharding)
        sigma0s = jax.device_put(sigma0s, sharding)

    state, trace = jax.jit(jax.vmap(solve))(mu0s, sigma0s, keys)
    return {
        "trace": trace,
        "K": state.ctl.K,
        "kff": state.ctl.kff,
        "sigma": state.ctl.sigma,
    }
