"""Distributionally-robust Guided Policy Search (RGPS).

JAX re-implementation of ``trajopt.rgps.{LRGPS, MBRGPS, MFRGPS}``
(rgps/lrgps.py:33, rgps/mbrgps.py:36, rgps/mfrgps.py:35).  An adversary perturbs the
dynamics-parameter distribution θ = vec([A B c]) ~ MatrixNormal within a KL ball of a
nominal; the min-max is solved by alternating

1. **adversary optimization** — geometric bisection on the dual β with an inner
   fixed-point loop coupling the adversary backward pass and the cubature forward
   pass, damped by KL-geodesic interpolation (mbrgps.py:378-451, 600-631); the whole
   fixed point compiles into one ``lax.while_loop`` device program here, and
2. **policy optimization** — scipy L-BFGS-B on the policy dual α driving a single
   jitted chain augment → robust backward → cubature forward → expectation/KL
   (mbrgps.py:284-306, 678-702).

Variants: :class:`LRGPS` (linear env, analytic nominal fixed once, lrgps.py:100-112),
:class:`MBRGPS` (nonlinear env, nominal relinearized along the mean trajectory each
accepted iteration, mbrgps.py:747-754), :class:`MFRGPS` (nominal = learned meanfield
MatrixNormal posterior from sampled rollouts, mfrgps.py:87, 542-572).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.optimize
from jax import lax

from ..core.cubature import (
    cubature_forward_pass,
    parameter_augment_cost,
    parameter_backward_pass,
    policy_backward_pass,
)
from ..core.diff import quadratize_cost_abs
from ..core.ekf import extended_kalman
from ..core.scan_lqr import (
    augment_cost_kl,
    gaussian_interp_kl,
    gaussian_interp_w2,
    gaussian_kl,
    policy_kl,
    quad_expectation,
)
from ..core.types import (
    GaussianSequence,
    LinearGaussianPolicy,
    MatrixNormalParams,
    vec_from_matrices,
)
from .common import make_weighting


class _RGPSBase:
    """Shared RGPS machinery (duals, fixed points, bisection)."""

    def __init__(
        self,
        env,
        nb_steps: int,
        init_state,
        init_action_sigma: float = 1.0,
        policy_kl_bound: float = 0.1,
        param_nominal_kl_bound: float = 100.0,
        param_regularizer_kl_bound: float = 1.0,
        policy_kl_stepwise: bool = False,
        activation: dict | None = None,
        slew_rate: bool = False,
        action_penalty=None,
        nominal_variance: float = 1e-8,
        interp: str = "kl",
        key=None,
    ):
        overrides = {"slew_rate": slew_rate}
        if action_penalty is not None:
            overrides["uw"] = tuple(float(action_penalty) for _ in range(env.dm_act))
        self.env = env.replace(**overrides)

        self.nb_steps = nb_steps
        self.dm_state = env.dm_state
        self.dm_act = env.dm_act
        self.dm_param = self.dm_state * (self.dm_state + self.dm_act + 1)

        mu0, sigma0 = init_state
        self.mu0 = jnp.asarray(mu0)
        self.sigma0 = jnp.asarray(sigma0)

        self.policy_kl_stepwise = policy_kl_stepwise
        n_alpha = nb_steps if policy_kl_stepwise else 1
        self.policy_kl_bound = policy_kl_bound * np.ones(n_alpha)
        self.alpha = 1e8 * np.ones(n_alpha)

        self.param_nominal_kl_bound = float(param_nominal_kl_bound)
        self.beta = 1e16
        self.param_regularizer_kl_bound = float(param_regularizer_kl_bound)
        self.eta = 1e16

        self.weighting = make_weighting(nb_steps, activation)

        # process noise assumed known (mbrgps.py:96-99)
        self.noise = jnp.tile(
            jnp.asarray(env.sigma), (nb_steps, 1, 1)
        )

        p = self.dm_param
        self.param = MatrixNormalParams(
            mu=jnp.zeros((nb_steps, p)), sigma=jnp.tile(jnp.eye(p), (nb_steps, 1, 1))
        )
        self.nominal = MatrixNormalParams(
            mu=jnp.zeros((nb_steps, p)),
            sigma=nominal_variance * jnp.tile(jnp.eye(p), (nb_steps, 1, 1)),
        )

        key = jax.random.PRNGKey(0) if key is None else key
        self._key = key
        self.ctl = LinearGaussianPolicy(
            K=jnp.zeros((nb_steps, self.dm_act, self.dm_state)),
            kff=jnp.zeros((nb_steps, self.dm_act)),
            sigma=jnp.tile(init_action_sigma * jnp.eye(self.dm_act), (nb_steps, 1, 1)),
        )

        self.xdist = GaussianSequence(
            mu=jnp.zeros((nb_steps + 1, self.dm_state)).at[0].set(self.mu0),
            sigma=jnp.tile(jnp.eye(self.dm_state), (nb_steps + 1, 1, 1))
            .at[0]
            .set(self.sigma0),
        )
        self.udist: GaussianSequence | None = None
        self.xudist: GaussianSequence | None = None
        self.cost = None
        self.vfunc = None
        self.qfunc = None

        self._quadratize = jax.jit(
            lambda xmu, umu: quadratize_cost_abs(self.env.cost, xmu, umu, self.weighting)
        )
        self._cubature = jax.jit(
            lambda ctl, param: cubature_forward_pass(
                self.mu0, self.sigma0, param, self.noise, ctl
            )
        )
        if interp not in ("kl", "w2"):
            raise ValueError(f"unknown interp {interp!r} (options: 'kl', 'w2')")
        self.interp = interp

        from ..utils.metrics import MetricsRecorder
        self.metrics = MetricsRecorder(type(self).__name__.lower())

        self._policy_dual_jit = jax.jit(self._policy_dual_impl)
        self._policy_solution_jit = jax.jit(self._policy_solution_impl)
        self._param_fixed_point_jit = jax.jit(self._param_fixed_point_impl)

    # ------------------------------------------------------------------ policy side
    def _alpha_vec(self, alpha):
        alpha = jnp.asarray(alpha)
        if alpha.shape[0] == 1:
            alpha = alpha * jnp.ones(self.nb_steps)
        return alpha

    def _policy_dual_impl(self, alpha, cost, ctl, param, kl_bound):
        """Policy dual: augment → robust backward → cubature forward → expectation
        (mbrgps.py:284-306), one device program."""
        agcost = augment_cost_kl(cost, ctl, alpha)
        lgc, xvalue, _, _ = policy_backward_pass(agcost, param, self.noise, alpha)
        xdist, _, _ = cubature_forward_pass(self.mu0, self.sigma0, param, self.noise, lgc)

        dual = quad_expectation(
            xdist.mu[0], xdist.sigma[0], xvalue.V[0], xvalue.v[0], xvalue.v0[0]
        )
        kl = policy_kl(lgc, ctl, xdist)

        if self.policy_kl_stepwise:
            dual = dual - jnp.sum(alpha * kl_bound)
            grad = kl - kl_bound
        else:
            dual = dual - alpha[0] * kl_bound[0]
            grad = jnp.sum(kl) - kl_bound[0:1]
        return -1.0 * dual, -1.0 * grad

    def _policy_solution_impl(self, alpha, cost, ctl, param):
        agcost = augment_cost_kl(cost, ctl, alpha)
        lgc, xvalue, xuvalue, diverge = policy_backward_pass(
            agcost, param, self.noise, alpha
        )
        xdist, udist, xudist = cubature_forward_pass(
            self.mu0, self.sigma0, param, self.noise, lgc
        )
        kl = policy_kl(lgc, ctl, xdist)
        return lgc, xvalue, xuvalue, xdist, udist, xudist, kl, diverge

    def policy_optimization(self, param):
        """L-BFGS-B on the policy dual (mbrgps.py:678-702)."""
        n_alpha = self.nb_steps if self.policy_kl_stepwise else 1
        init = 1e4 * np.ones(n_alpha)
        bounds = ((1e-16, 1e16),) * n_alpha
        kl_bound = jnp.asarray(self.policy_kl_bound)

        def dual_fn(alpha):
            d, g = self._policy_dual_jit(
                self._alpha_vec(alpha), self.cost, self.ctl, param, kl_bound
            )
            return np.asarray(d, dtype=np.float64), np.asarray(g, dtype=np.float64)

        res = scipy.optimize.minimize(
            dual_fn, init, method="L-BFGS-B", jac=True, bounds=bounds,
            options={"disp": False, "maxiter": 100000, "ftol": 1e-12},
        )
        alpha = res.x

        lgc, xvalue, xuvalue, worst_xdist, worst_udist, worst_xudist, kl, _ = (
            self._policy_solution_jit(self._alpha_vec(alpha), self.cost, self.ctl, param)
        )
        return lgc, worst_xdist, xvalue, xuvalue, alpha, kl

    def policy_kldiv(self, lgc, xdist):
        return policy_kl(lgc, self.ctl, xdist)

    # ------------------------------------------------------------------ adversary side
    def _param_fixed_point_impl(
        self, agCpp, agcp, ctl, xdist0, beta_plus_eta, max_iters
    ):
        """The adversary fixed point: alternate parameter backward pass and cubature
        forward pass, KL-damped, until the state distributions agree
        (mbrgps.py:386-408) — one ``lax.while_loop`` device program."""
        T = self.nb_steps
        p = self.dm_param
        dummy_param = MatrixNormalParams(
            mu=jnp.zeros((T, p)), sigma=jnp.tile(jnp.eye(p), (T, 1, 1))
        )

        def cond(state):
            q, param, value, kl, diverged, it = state
            return (jnp.any(kl > 1e-3)) & (~diverged) & (it < max_iters)

        def body(state):
            q, _, _, _, _, it = state
            param, value, diverged = parameter_backward_pass(
                q, ctl, self.noise, self.cost, agCpp, agcp, beta_plus_eta
            )
            p_xdist, _, _ = cubature_forward_pass(
                self.mu0, self.sigma0, param, self.noise, ctl
            )
            kl = gaussian_kl(p_xdist, q)
            # damping geodesic: KL (the reference's live path, mbrgps.py:407)
            # or W2 (its available alternative, mbrgps.py:561-577)
            damp = gaussian_interp_w2 if self.interp == "w2" else gaussian_interp_kl
            q_new = damp(q, p_xdist, 1e-1)
            return (q_new, param, value, kl, diverged, it + 1)

        init = (
            xdist0,
            dummy_param,
            parameter_backward_pass(
                xdist0, ctl, self.noise, self.cost, agCpp, agcp, beta_plus_eta
            )[1],
            jnp.full(self.nb_steps + 1, jnp.inf),
            jnp.asarray(False),
            jnp.asarray(0),
        )
        q, param, value, kl, diverged, iters = lax.while_loop(cond, body, init)
        return q, param, value, diverged, iters

    def parameter_nominal_kldiv(self, param):
        return gaussian_kl(
            GaussianSequence(mu=param.mu, sigma=param.sigma),
            GaussianSequence(mu=self.nominal.mu, sigma=self.nominal.sigma),
        )

    def _parameter_dual(self, beta, ctl, reference, eta=0.0):
        """Adversary dual value/gradient at a given β (mbrgps.py:378-417)."""
        agCpp, agcp, _ = parameter_augment_cost(reference, jnp.asarray(beta + eta))
        q, param, value, diverged, _ = self._param_fixed_point_jit(
            agCpp, agcp, ctl, self.xdist, jnp.asarray(beta + eta), 100
        )
        if bool(diverged):
            return np.nan, np.nan, param

        dual = quad_expectation(
            q.mu[0], q.sigma[0], value.V[0], value.v[0], value.v0[0]
        )
        nom_kl = float(jnp.sum(self.parameter_nominal_kldiv(param)))
        dual = float(dual) + beta * (nom_kl - self.param_nominal_kl_bound)
        grad = nom_kl - self.param_nominal_kl_bound
        return -dual, -grad, param

    def parameter_dual_optimization(self, beta, ctl, iters=50):
        """Geometric bisection on β (mbrgps.py:419-451)."""
        min_beta, max_beta = 1e-4, 1e64
        best_beta, best_dual, best_grad = beta, np.inf, np.inf

        for _ in range(iters):
            dual, grad, _ = self._parameter_dual(beta, ctl, self.nominal)
            if not np.isnan(dual) and not np.isnan(grad):
                if grad < best_grad:
                    best_beta, best_dual, best_grad = beta, dual, grad
                if abs(grad) < 0.1 * self.param_nominal_kl_bound:
                    return beta, dual, grad
                if grad > 0:  # beta too large
                    max_beta = beta
                else:
                    min_beta = beta
                beta = np.sqrt(min_beta * max_beta)
            else:
                min_beta = beta
                beta = np.sqrt(min_beta * max_beta)
        return best_beta, best_dual, best_grad

    def parameter_optimization(self, ctl, iters=50):
        """Worst-case parameter distribution at the bisected β* (mbrgps.py:600-631)."""
        beta, _, _ = self.parameter_dual_optimization(1e16, ctl, iters=iters)
        agCpp, agcp, _ = parameter_augment_cost(self.nominal, jnp.asarray(beta))
        _, param, _, diverged, _ = self._param_fixed_point_jit(
            agCpp, agcp, ctl, self.xdist, jnp.asarray(beta), 100
        )
        return param, beta

    def _regularized_parameter_dual(self, eta, ctl, last):
        """Regularized adversary dual: KL penalty toward the *last* iterate with dual
        η against the per-step regularizer bound (mbrgps.py:459-498)."""
        agCpp, agcp, _ = parameter_augment_cost(last, jnp.asarray(eta))
        q, param, value, diverged, _ = self._param_fixed_point_jit(
            agCpp, agcp, ctl, self.xdist, jnp.asarray(eta), 100
        )
        if bool(diverged):
            return np.nan, np.nan, param

        dual = quad_expectation(
            q.mu[0], q.sigma[0], value.V[0], value.v[0], value.v0[0]
        )
        reg_kl = float(
            jnp.sum(
                gaussian_kl(
                    GaussianSequence(mu=param.mu, sigma=param.sigma),
                    GaussianSequence(mu=last.mu, sigma=last.sigma),
                )
            )
        )
        dual = float(dual) + eta * (reg_kl - self.param_regularizer_kl_bound)
        grad = reg_kl - self.param_regularizer_kl_bound
        return -dual, -grad, param

    def regularized_parameter_optimization(self, ctl, iters=10):
        """Iterated small-KL adversary steps until the total KL-to-nominal budget is
        spent (mbrgps.py:633-676)."""
        last = self.nominal
        eta = 1e16
        param_nom_kl = 0.0
        guard = 0
        while param_nom_kl < self.param_nominal_kl_bound and guard < 100:
            guard += 1
            # bisection on eta against the regularizer bound (mbrgps.py:500-532)
            min_eta, max_eta = 1e-4, 1e64
            best_eta, best_grad = eta, np.inf
            for _ in range(iters):
                dual, grad, _ = self._regularized_parameter_dual(eta, ctl, last)
                if not np.isnan(dual) and not np.isnan(grad):
                    if grad < best_grad:
                        best_eta, best_grad = eta, grad
                    if abs(grad) < 0.1 * self.param_regularizer_kl_bound:
                        best_eta = eta
                        break
                    if grad > 0:  # eta too large
                        max_eta = eta
                    else:
                        min_eta = eta
                    eta = np.sqrt(min_eta * max_eta)
                else:
                    min_eta = eta
                    eta = np.sqrt(min_eta * max_eta)
            eta = best_eta

            agCpp, agcp, _ = parameter_augment_cost(last, jnp.asarray(eta))
            _, param, _, diverged, _ = self._param_fixed_point_jit(
                agCpp, agcp, ctl, self.xdist, jnp.asarray(eta), 100
            )
            reg_kl = float(
                jnp.sum(
                    gaussian_kl(
                        GaussianSequence(mu=param.mu, sigma=param.sigma),
                        GaussianSequence(mu=last.mu, sigma=last.sigma),
                    )
                )
            )
            if abs(reg_kl - self.param_regularizer_kl_bound) \
                    < 0.1 * self.param_regularizer_kl_bound:
                last = param
                param_nom_kl = float(jnp.sum(self.parameter_nominal_kldiv(param)))
        return last, eta

    # ------------------------------------------------------------------ shared loop
    def _accept_and_log(self, it, lgc, xvalue, xuvalue, alpha, policy_kl_np,
                        param_nom_kl, ret, trace, verbose):
        self.alpha = alpha
        self.ctl = lgc
        self.vfunc, self.qfunc = xvalue, xuvalue
        trace.append(ret)
        self.metrics.log(
            it, ret=ret,
            param_kl_req=self.param_nominal_kl_bound, param_kl_act=param_nom_kl,
            policy_kl_req=float(np.sum(self.policy_kl_bound)),
            policy_kl_act=float(np.sum(policy_kl_np)),
            beta=float(self.beta), accepted=True,
        )
        if verbose:
            print(self.metrics.format_last())

    def _policy_kl_ok(self, policy_kl_np):
        return bool(
            np.all((policy_kl_np - self.policy_kl_bound) < 0.25 * self.policy_kl_bound)
            or np.all(policy_kl_np < self.policy_kl_bound)
        )


    def plot_distributions(self, xdist=None, udist=None, show: bool = True):
        """State/action marginal bands (rgps/mbrgps.py:704, lrgps.py:689)."""
        from ..utils.viz import plot_gaussian_trajectory

        return plot_gaussian_trajectory(
            self.xdist if xdist is None else xdist,
            self.udist if udist is None else udist,
            show=show,
        )

    def plot_parameters(self, t: int, axs=None, color: str = "b",
                        show: bool = True):
        """Adversary MatrixNormal marginals at step t (rgps/objects.py:63-75)."""
        from ..utils.viz import plot_matrixnormal_marginals

        return plot_matrixnormal_marginals(self.param, t, axs=axs, color=color,
                                           show=show)

    @staticmethod
    def plot_dual(dual_fun, opt=None, elow: float = 0.0, ehigh: float = 8.0,
                  logax: bool = True, show: bool = True):
        """Dual landscape debugger (rgps/mfrgps.py:704-736)."""
        from ..utils.viz import plot_dual_landscape

        return plot_dual_landscape(dual_fun, opt=opt, elow=elow, ehigh=ehigh,
                                   logax=logax, show=show)


class MBRGPS(_RGPSBase):
    """Model-based RGPS: nominal relinearized along the EKF mean trajectory each
    accepted iteration (rgps/mbrgps.py:36-825)."""

    def _propagate(self, lgc):
        xdist, udist, lgd = extended_kalman(self.env, lgc, self.mu0, self.sigma0)
        T = self.nb_steps
        u_last = jnp.concatenate([jnp.zeros((1, self.dm_act)), udist.mu[:-1]], axis=0)
        costs = jax.vmap(self.env.cost)(
            xdist.mu[:T], udist.mu, u_last, self.weighting[:T]
        )
        c_T = self.env.cost(
            xdist.mu[T], jnp.zeros(self.dm_act), jnp.zeros(self.dm_act),
            self.weighting[T],
        )
        return xdist, udist, lgd, jnp.concatenate([costs, c_T[None]])

    def _refresh_nominal(self, lgd):
        mu = jax.vmap(vec_from_matrices)(lgd.A, lgd.B, lgd.c)
        self.nominal = MatrixNormalParams(mu=mu, sigma=self.nominal.sigma)

    def run(self, nb_iter: int = 10, verbose: bool = False,
            optimize_adversary: bool = True,
            iterative_adversary: bool = False) -> list[float]:
        self.metrics.reset()  # history describes the latest run
        trace = []

        _, _, lgd, costs = self._propagate(self.ctl)
        self._refresh_nominal(lgd)
        self.xdist, self.udist, self.xudist = self._cubature(self.ctl, self.nominal)
        self.cost = self._quadratize(self.xdist.mu, self.udist.mu)
        trace.append(float(jnp.sum(costs)))

        for it in range(nb_iter):
            if optimize_adversary:
                if iterative_adversary:
                    self.param, self.eta = self.regularized_parameter_optimization(self.ctl)
                else:
                    self.param, self.beta = self.parameter_optimization(self.ctl)
            else:
                self.param = self.nominal

            param_nom_kl = float(jnp.sum(self.parameter_nominal_kldiv(self.param)))

            lgc, worst_xdist, xvalue, xuvalue, alpha, kl = self.policy_optimization(
                self.param
            )

            kl_np = np.asarray(kl)
            if not self.policy_kl_stepwise:
                kl_np = np.array([np.sum(kl_np)])

            if self._policy_kl_ok(kl_np):
                _, _, lgd, costs = self._propagate(lgc)
                self._refresh_nominal(lgd)
                self.xdist, self.udist, self.xudist = self._cubature(lgc, self.param)
                self.cost = self._quadratize(self.xdist.mu, self.udist.mu)
                self._accept_and_log(
                    it, lgc, xvalue, xuvalue, alpha, kl_np, param_nom_kl,
                    float(jnp.sum(costs)), trace, verbose,
                )
            else:
                self.metrics.log(it, policy_kl_act=float(np.sum(kl_np)),
                                 accepted=False)
                print("Something is wrong, KL not satisfied: req",
                      np.sum(self.policy_kl_bound), "act.", np.sum(kl_np))
                n_alpha = self.nb_steps if self.policy_kl_stepwise else 1
                self.alpha = 1e8 * np.ones(n_alpha)

        return trace


class LRGPS(_RGPSBase):
    """Robust GPS on a linear system: analytic nominal fixed once
    (rgps/lrgps.py:33-786)."""

    def __init__(self, env, nb_steps, init_state, **kwargs):
        super().__init__(env, nb_steps, init_state, **kwargs)

        # LQG dynamics linearized at the origin (lrgps.py:100-112)
        A, B, c = env._ABc()
        mu = vec_from_matrices(A, B, c)
        self.nominal = MatrixNormalParams(
            mu=jnp.tile(mu, (nb_steps, 1)), sigma=self.nominal.sigma
        )

    def _expected_cost(self, xdist, udist):
        """Quadratic cost expectation incl. trace terms
        (rgps/objects.py:128-142, stoch=True)."""
        from ..core.diff import evaluate_quadratic_cost

        base = evaluate_quadratic_cost(self.cost, xdist.mu, udist.mu)
        tx = jnp.einsum("tij,tji->", self.cost.Cxx, xdist.sigma)
        # actions contribute up to T-1 (objects.py:140-141)
        tu = jnp.einsum(
            "tij,tji->", self.cost.Cuu[: self.nb_steps - 1], udist.sigma[:-1]
        )
        return float(base + tx + tu)

    def run(self, nb_iter: int = 10, verbose: bool = False,
            optimize_adversary: bool = True,
            iterative_adversary: bool = False) -> list[float]:
        self.metrics.reset()  # history describes the latest run
        trace = []

        self.xdist, self.udist, self.xudist = self._cubature(self.ctl, self.nominal)
        self.cost = self._quadratize(self.xdist.mu, self.udist.mu)
        trace.append(self._expected_cost(self.xdist, self.udist))

        for it in range(nb_iter):
            if optimize_adversary:
                if iterative_adversary:
                    self.param, self.eta = self.regularized_parameter_optimization(self.ctl)
                else:
                    self.param, self.beta = self.parameter_optimization(self.ctl)
            else:
                self.param = self.nominal

            param_nom_kl = float(jnp.sum(self.parameter_nominal_kldiv(self.param)))

            lgc, worst_xdist, xvalue, xuvalue, alpha, kl = self.policy_optimization(
                self.param
            )

            kl_np = np.asarray(kl)
            if not self.policy_kl_stepwise:
                kl_np = np.array([np.sum(kl_np)])

            if self._policy_kl_ok(kl_np):
                self.xdist, self.udist, self.xudist = self._cubature(lgc, self.param)
                ret = self._expected_cost(self.xdist, self.udist)
                self.cost = self._quadratize(self.xdist.mu, self.udist.mu)
                self._accept_and_log(
                    it, lgc, xvalue, xuvalue, alpha, kl_np, param_nom_kl, ret,
                    trace, verbose,
                )
            else:
                self.metrics.log(it, policy_kl_act=float(np.sum(kl_np)),
                                 accepted=False)
                print("Something is wrong, KL not satisfied: req",
                      np.sum(self.policy_kl_bound), "act.", np.sum(kl_np))
                n_alpha = self.nb_steps if self.policy_kl_stepwise else 1
                self.alpha = 1e8 * np.ones(n_alpha)

        return trace


class MFRGPS(_RGPSBase):
    """Model-free RGPS: nominal = learned meanfield MatrixNormal posterior over θ from
    sampled rollouts (rgps/mfrgps.py:35-702)."""

    def __init__(self, env, nb_steps, init_state, prior=None, **kwargs):
        super().__init__(env, nb_steps, init_state, **kwargs)
        self.prior = {"K": 1e-6, "psi": 1e-8, "nu": 0.1} if prior is None else prior
        self.data: dict = {}

    def plot_data(self, show: bool = True):
        """Sampled-rollout data plot (mfrgps.py:493); requires a prior run()."""
        from ..utils.viz import plot_rollout_data

        return plot_rollout_data(self.data, show=show)

    def rollout(self, nb_episodes: int, stoch: bool = True, key=None) -> dict:
        from .common import rollout_batch

        if key is None:
            self._key, key = jax.random.split(self._key)
        return rollout_batch(
            self.env, self.ctl, key, self.weighting, nb_episodes, stoch_policy=stoch
        )

    def learn_nominal(self, data: dict):
        from ..parallel.regression import mniw_meanfield_params

        nominal, noise = mniw_meanfield_params(
            data["x"], data["u"], data["xn"], self.prior
        )
        self.nominal = nominal
        self.noise = noise

    def run(self, nb_learning_episodes: int = 25, nb_iter: int = 10,
            nb_evaluation_episodes: int | None = None,
            verbose: bool = False) -> list[float]:
        self.metrics.reset()  # history describes the latest run
        trace = []

        self.data = self.rollout(nb_learning_episodes)
        self.learn_nominal(self.data)
        self.xdist, self.udist, self.xudist = self._cubature(self.ctl, self.nominal)
        self.cost = self._quadratize(self.xdist.mu, self.udist.mu)

        last_return = float(jnp.mean(jnp.sum(self.data["c"], axis=1)))
        trace.append(last_return)

        for it in range(nb_iter):
            self.param, self.beta = self.parameter_optimization(self.ctl)
            param_nom_kl = float(jnp.sum(self.parameter_nominal_kldiv(self.param)))

            lgc, worst_xdist, xvalue, xuvalue, alpha, kl = self.policy_optimization(
                self.param
            )

            kl_np = np.asarray(kl)
            if not self.policy_kl_stepwise:
                kl_np = np.array([np.sum(kl_np)])

            if self._policy_kl_ok(kl_np):
                self.ctl = lgc
                self.data = self.rollout(nb_learning_episodes)
                if nb_evaluation_episodes is not None:
                    ev = self.rollout(nb_evaluation_episodes, stoch=False)
                    ret = float(jnp.mean(jnp.sum(ev["c"], axis=1)))
                else:
                    ret = float(jnp.mean(jnp.sum(self.data["c"], axis=1)))

                self.learn_nominal(self.data)
                self.xdist, self.udist, self.xudist = self._cubature(self.ctl, self.param)
                self.cost = self._quadratize(self.xdist.mu, self.udist.mu)
                self._accept_and_log(
                    it, lgc, xvalue, xuvalue, alpha, kl_np, param_nom_kl, ret,
                    trace, verbose,
                )
            else:
                self.metrics.log(it, policy_kl_act=float(np.sum(kl_np)),
                                 accepted=False)
                print("Something is wrong, KL not satisfied: req",
                      np.sum(self.policy_kl_bound), "act.", np.sum(kl_np))
                n_alpha = self.nb_steps if self.policy_kl_stepwise else 1
                self.alpha = 1e8 * np.ones(n_alpha)

        return trace
