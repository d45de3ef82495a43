"""KL-constrained trajectory optimization (Guided Policy Search).

JAX re-implementation of ``trajopt.gps.MBGPS`` / ``MFGPS``
(gps/mbgps.py:16-325, gps/mfgps.py:17-...).  The dual evaluation — the hottest path of
the reference, calling five C++ kernels per SLSQP iterate (mbgps.py:173-195) — compiles
here into **one** jitted device program: augment → soft-KL backward scan → Gaussian
forward scan → expectation/KL reductions.  The SLSQP dual optimization itself stays on
host (scipy, as in the reference, mbgps.py:250-255) driving that compiled dual.

MFGPS replaces the analytic linearization with per-timestep Bayesian linear regression
over sampled rollouts (gps/objects.py:215-236 via the ``mimo`` package); here that is a
closed-form MatrixNormal(-inverse-Wishart) MAP update, vmapped over the horizon
(parallel/regression.py), with the rollout batch generated as one vmapped scan.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.optimize

from ..core.diff import evaluate_quadratic_cost, quadratize_cost_abs
from ..core.ekf import extended_kalman
from ..core.scan_lqr import (
    augment_cost_kl,
    gaussian_forward,
    gps_backward,
    policy_kl,
    quad_expectation,
)
from ..core.types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
)
from .common import make_weighting


class MBGPS:
    """Model-based GPS: analytic relinearization along the EKF mean trajectory."""

    def __init__(
        self,
        env,
        nb_steps: int,
        init_state,
        init_action_sigma: float = 1.0,
        kl_bound: float = 0.1,
        kl_adaptive: bool = False,
        kl_stepwise: bool = False,
        activation: dict | None = None,
        slew_rate: bool = False,
        action_penalty=None,
        key=None,
    ):
        overrides = {"slew_rate": slew_rate}
        if action_penalty is not None:
            overrides["uw"] = tuple(float(action_penalty) for _ in range(env.dm_act))
        self.env = env.replace(**overrides)

        self.nb_steps = nb_steps
        self.dm_state = env.dm_state
        self.dm_act = env.dm_act

        mu0, sigma0 = init_state
        self.mu0 = jnp.asarray(mu0)
        self.sigma0 = jnp.asarray(sigma0)

        self.kl_stepwise = kl_stepwise
        n_alpha = nb_steps if kl_stepwise else 1
        self.kl_base = kl_bound * np.ones(n_alpha)
        self.kl_bound = kl_bound * np.ones(n_alpha)
        self.alpha = 1e8 * np.ones(n_alpha)

        self.kl_adaptive = kl_adaptive
        self.kl_mult, self.kl_mult_min, self.kl_mult_max = 1.0, 0.1, 5.0

        self.weighting = make_weighting(nb_steps, activation)

        # initial linear-Gaussian controller with small random feedforward
        # (mbgps.py:72-73)
        key = jax.random.PRNGKey(0) if key is None else key
        self.ctl = LinearGaussianPolicy(
            K=jnp.zeros((nb_steps, self.dm_act, self.dm_state)),
            kff=1e-4 * jax.random.normal(key, (nb_steps, self.dm_act)),
            sigma=jnp.tile(
                init_action_sigma * jnp.eye(self.dm_act), (nb_steps, 1, 1)
            ),
        )

        self.xdist = GaussianSequence(
            mu=jnp.zeros((nb_steps + 1, self.dm_state)).at[0].set(self.mu0),
            sigma=jnp.tile(jnp.eye(self.dm_state), (nb_steps + 1, 1, 1))
            .at[0]
            .set(self.sigma0),
        )
        self.udist: GaussianSequence | None = None
        self.dyn: LinearGaussianDynamics | None = None
        self.cost = None
        self.vfunc = None
        self.qfunc = None
        self.last_return = -np.inf

        self._propagate = jax.jit(self._propagate_impl)
        self._dual = jax.jit(self._dual_impl)
        self._solution = jax.jit(self._solution_impl)
        self._quadratize = jax.jit(
            lambda xmu, umu: quadratize_cost_abs(
                self.env.cost, xmu, umu, self.weighting
            )
        )

    # ------------------------------------------------------------------ jitted cores
    def _propagate_impl(self, ctl):
        """EKF mean/cov propagation + stage costs along the mean path
        (mbgps.py:125-133)."""
        xdist, udist, lgd = extended_kalman(self.env, ctl, self.mu0, self.sigma0)

        T = self.nb_steps
        u_last = jnp.concatenate(
            [jnp.zeros((1, self.dm_act)), udist.mu[:-1]], axis=0
        )
        costs = jax.vmap(self.env.cost)(
            xdist.mu[:T], udist.mu, u_last, self.weighting[:T]
        )
        c_T = self.env.cost(
            xdist.mu[T],
            jnp.zeros(self.dm_act),
            jnp.zeros(self.dm_act),
            self.weighting[T],
        )
        return xdist, udist, lgd, jnp.concatenate([costs, c_T[None]])

    def _dual_impl(self, alpha, cost, dyn, ctl, xmu0, xsigma0, kl_bound):
        """One dual evaluation — the reference's five-kernel chain (mbgps.py:173-195)
        fused into a single program.  alpha: (T,)."""
        agcost = augment_cost_kl(cost, ctl, alpha)
        lgc, xvalue, _, _ = gps_backward(agcost, dyn, alpha)
        xdist, _, _ = gaussian_forward(dyn, lgc, xmu0, xsigma0)

        dual = quad_expectation(
            xdist.mu[0], xdist.sigma[0], xvalue.V[0], xvalue.v[0], xvalue.v0[0]
        )
        kl = policy_kl(lgc, ctl, xdist)

        if self.kl_stepwise:
            dual = dual - jnp.sum(alpha * kl_bound)
            grad = kl - kl_bound
        else:
            dual = dual - alpha[0] * kl_bound[0]
            grad = jnp.sum(kl) - kl_bound[0:1]
        return -1.0 * dual, -1.0 * grad

    def _solution_impl(self, alpha, cost, dyn, ctl, xmu0, xsigma0):
        """Re-compute controller/value/dists at the optimized dual (mbgps.py:259-264)."""
        agcost = augment_cost_kl(cost, ctl, alpha)
        lgc, xvalue, xuvalue, diverge = gps_backward(agcost, dyn, alpha)
        xdist, udist, xudist = gaussian_forward(dyn, lgc, xmu0, xsigma0)
        kl = policy_kl(lgc, ctl, xdist)
        expected = evaluate_quadratic_cost(cost, xdist.mu, udist.mu)
        return lgc, xvalue, xuvalue, xdist, udist, xudist, kl, expected, diverge

    # ------------------------------------------------------------------ helpers
    def _alpha_vec(self, alpha) -> jnp.ndarray:
        """Broadcast a scalar dual to the horizon (pass_alpha_as_vector,
        gps/objects.py:306-314)."""
        alpha = jnp.asarray(alpha)
        if alpha.shape[0] == 1:
            alpha = alpha * jnp.ones(self.nb_steps)
        return alpha

    def kldiv(self, lgc, xdist):
        return policy_kl(lgc, self.ctl, xdist)

    # ------------------------------------------------------------------ main loop
    def plot(self, show: bool = True):
        """State/action marginals with ±2σ bands (gps/mbgps.py:203-224)."""
        from ..utils.viz import plot_gaussian_trajectory

        return plot_gaussian_trajectory(self.xdist, self.udist, show=show)

    # reference alias (mfgps.py:190, rgps/*.plot_distributions)
    plot_distributions = plot

    def run(self, nb_iter: int = 10, verbose: bool = False) -> list[float]:
        from ..utils.metrics import MetricsRecorder
        self.metrics = MetricsRecorder("mbgps")  # fresh history per run
        trace = []

        xdist, udist, lgd, costs = self._propagate(self.ctl)
        self.xdist, self.udist, self.dyn = xdist, udist, lgd
        self.cost = self._quadratize(xdist.mu, udist.mu)
        self.last_return = float(jnp.sum(costs))
        trace.append(self.last_return)
        self.metrics.log(-1, ret=self.last_return, accepted=True)

        n_alpha = self.nb_steps if self.kl_stepwise else 1
        for it in range(nb_iter):
            init = 1e4 * np.ones(n_alpha)
            bounds = ((1e-16, 1e16),) * n_alpha

            def dual_fn(alpha):
                d, g = self._dual(
                    self._alpha_vec(alpha),
                    self.cost, self.dyn, self.ctl,
                    self.xdist.mu[0], self.xdist.sigma[0],
                    jnp.asarray(self.kl_bound),
                )
                return np.asarray(d, dtype=np.float64), np.asarray(
                    g, dtype=np.float64
                )

            res = scipy.optimize.minimize(
                dual_fn, init, method="SLSQP", jac=True, bounds=bounds,
                options={"disp": False, "maxiter": 10000, "ftol": 1e-6},
            )
            self.alpha = res.x

            (lgc, xvalue, xuvalue, xdist, udist, xudist,
             kl, expected_return, diverge) = self._solution(
                self._alpha_vec(self.alpha),
                self.cost, self.dyn, self.ctl,
                self.xdist.mu[0], self.xdist.sigma[0],
            )

            kl_np = np.asarray(kl)
            if not self.kl_stepwise:
                kl_np = np.array([np.sum(kl_np)])

            # KL-constraint acceptance (mbgps.py:271)
            if np.all(np.abs(kl_np - self.kl_bound) < 0.25 * self.kl_bound):
                self.ctl = lgc

                xdist_m, udist_m, lgd, costs = self._propagate(lgc)
                ret = float(jnp.sum(costs))

                expected_imp = self.last_return - float(expected_return)
                actual_imp = self.last_return - ret

                if self.kl_adaptive:
                    mult = expected_imp / (
                        2.0 * np.maximum(1e-4, expected_imp - actual_imp)
                    )
                    mult = np.maximum(0.1, np.minimum(5.0, mult))
                    self.kl_mult = np.maximum(
                        np.minimum(mult * self.kl_mult, self.kl_mult_max),
                        self.kl_mult_min,
                    )

                self.dyn = lgd
                self.xdist, self.udist = xdist_m, udist_m
                self.cost = self._quadratize(xdist_m.mu, udist_m.mu)
                self.vfunc, self.qfunc = xvalue, xuvalue
                trace.append(ret)
                self.last_return = ret

                if self.kl_adaptive:
                    self.kl_bound = self.kl_base * self.kl_mult

                self.metrics.log(
                    it, ret=ret, kl_req=float(np.sum(self.kl_bound)),
                    kl_act=float(np.sum(kl_np)), alpha=float(np.sum(self.alpha)),
                    accepted=True,
                )
                if verbose:
                    print(self.metrics.format_last())
            else:
                print("Something is wrong, KL not satisfied")
                self.metrics.log(it, kl_req=float(np.sum(self.kl_bound)),
                                 kl_act=float(np.sum(kl_np)), accepted=False)
                self.alpha = 1e8 * np.ones(n_alpha)

        return trace


class MFGPS(MBGPS):
    """Model-free GPS: dynamics learned per-timestep from sampled rollouts by
    Bayesian MatrixNormal(-inverse-Wishart) linear regression (gps/mfgps.py:17,
    gps/objects.py:215-236)."""

    def __init__(
        self,
        env,
        nb_steps: int,
        init_state,
        init_action_sigma: float = 1.0,
        kl_bound: float = 0.1,
        kl_adaptive: bool = False,
        kl_stepwise: bool = False,
        activation: dict | None = None,
        slew_rate: bool = False,
        action_penalty=None,
        prior: dict | None = None,
        key=None,
    ):
        super().__init__(
            env, nb_steps, init_state, init_action_sigma, kl_bound, kl_adaptive,
            kl_stepwise, activation, slew_rate, action_penalty, key,
        )
        self.prior = {"K": 1e-6, "psi": 1e-8, "nu": 0.1} if prior is None else prior
        self.data: dict = {}
        self._rollout_key = jax.random.PRNGKey(1) if key is None else key

    def plot_data(self, show: bool = True):
        """Sampled-rollout data plot (mfgps.py:213-226); requires a prior run()."""
        from ..utils.viz import plot_rollout_data

        return plot_rollout_data(self.data, show=show)

    def rollout(self, nb_episodes: int, stoch: bool = True, key=None) -> dict:
        from .common import rollout_batch

        if key is None:
            self._rollout_key, key = jax.random.split(self._rollout_key)
        return rollout_batch(
            self.env, self.ctl, key, self.weighting, nb_episodes,
            stoch_policy=stoch,
        )

    def learn_dynamics(self, data: dict) -> LinearGaussianDynamics:
        from ..parallel.regression import mniw_map_regression

        return mniw_map_regression(
            data["x"], data["u"], data["xn"], self.prior
        )

    def run(
        self, nb_iter: int = 10, nb_episodes: int = 50, verbose: bool = False
    ) -> list[float]:
        from ..utils.metrics import MetricsRecorder
        self.metrics = MetricsRecorder("mfgps")  # fresh history per run
        trace = []

        # sample real rollouts, learn time-varying linear dynamics (mfgps.py:95-125)
        self.data = self.rollout(nb_episodes)
        self.dyn = self.learn_dynamics(self.data)

        # moment-match the sampled state/action dists for the quadratization point
        xmu = jnp.concatenate(
            [jnp.mean(self.data["x"], axis=0),
             jnp.mean(self.data["xn"][:, -1:], axis=0)], axis=0
        )
        umu = jnp.mean(self.data["u"], axis=0)
        self.cost = self._quadratize(xmu, umu)

        self.last_return = float(jnp.mean(jnp.sum(self.data["c"], axis=1)))
        trace.append(self.last_return)
        self.metrics.log(-1, ret=self.last_return, accepted=True)

        n_alpha = self.nb_steps if self.kl_stepwise else 1
        for it in range(nb_iter):
            init = 1e4 * np.ones(n_alpha)
            bounds = ((1e-16, 1e16),) * n_alpha

            def dual_fn(alpha):
                d, g = self._dual(
                    self._alpha_vec(alpha), self.cost, self.dyn, self.ctl,
                    self.xdist.mu[0], self.xdist.sigma[0],
                    jnp.asarray(self.kl_bound),
                )
                return np.asarray(d, dtype=np.float64), np.asarray(g, dtype=np.float64)

            res = scipy.optimize.minimize(
                dual_fn, init, method="SLSQP", jac=True, bounds=bounds,
                options={"disp": False, "maxiter": 10000, "ftol": 1e-6},
            )
            self.alpha = res.x

            (lgc, xvalue, xuvalue, xdist, udist, xudist,
             kl, expected_return, diverge) = self._solution(
                self._alpha_vec(self.alpha), self.cost, self.dyn, self.ctl,
                self.xdist.mu[0], self.xdist.sigma[0],
            )

            kl_np = np.asarray(kl)
            if not self.kl_stepwise:
                kl_np = np.array([np.sum(kl_np)])

            if np.all(np.abs(kl_np - self.kl_bound) < 0.25 * self.kl_bound):
                self.ctl = lgc
                self.xdist, self.udist = xdist, udist

                self.data = self.rollout(nb_episodes)
                self.dyn = self.learn_dynamics(self.data)

                xmu = jnp.concatenate(
                    [jnp.mean(self.data["x"], axis=0),
                     jnp.mean(self.data["xn"][:, -1:], axis=0)], axis=0
                )
                umu = jnp.mean(self.data["u"], axis=0)
                self.cost = self._quadratize(xmu, umu)

                ret = float(jnp.mean(jnp.sum(self.data["c"], axis=1)))
                self.vfunc, self.qfunc = xvalue, xuvalue
                trace.append(ret)
                self.last_return = ret

                self.metrics.log(it, ret=ret, kl_act=float(np.sum(kl_np)),
                                 accepted=True)
                if verbose:
                    print(self.metrics.format_last())
            else:
                print("Something is wrong, KL not satisfied")
                self.metrics.log(it, kl_act=float(np.sum(kl_np)), accepted=False)
                self.alpha = 1e8 * np.ones(n_alpha)

        return trace
