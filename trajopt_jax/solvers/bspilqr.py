"""Belief-space iLQR (van den Berg et al.).

JAX re-implementation of ``trajopt.bspilqr.BSPiLQR`` (bspilqr/bspilqr.py:11-224):
the belief (μ, Σ) is propagated through one EKF predict+gain step per control step; the
value function carries the extra vec(Σ) channel ``tau``.  The hot path of the reference
— the autograd jacobian of the hand-flattened belief-update map, O((b+b²+a)·b²) per
timestep (bspilqr/objects.py:235-256) — becomes one vmapped ``jacfwd`` over the horizon;
the C++ backward pass (bspilqr/src/util.cpp:83-204) becomes a ``lax.scan``; the
line-search forward passes run as a vmap over the α-grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.belief import (
    belief_cost_expansion,
    belief_dynamics_expansion,
    bsp_backward,
)
from ..core.ekf import belief_ekf_step
from ..core.types import LinearPolicy
from .common import DEFAULT_ALPHAS


class BSPiLQR:

    def __init__(
        self,
        env,
        nb_steps: int,
        init_belief,
        alphas=DEFAULT_ALPHAS,
        lmbda: float = 1.0,
        dlmbda: float = 1.0,
        min_lmbda: float = 1e-6,
        max_lmbda: float = 1e6,
        mult_lmbda: float = 1.6,
        tolfun: float = 1e-8,
        tolgrad: float = 1e-6,
        min_imp: float = 0.0,
        reg: int = 1,
        key=None,
    ):
        self.env = env
        self.nb_steps = nb_steps
        self.belief_dim = env.belief_dim
        self.act_dim = env.act_dim

        mu0, sigma0 = init_belief
        self.mu0 = jnp.asarray(mu0)
        self.sigma0 = jnp.asarray(sigma0)

        self.alphas = jnp.asarray(alphas)
        self.lmbda = lmbda
        self.dlmbda = dlmbda
        self.min_lmbda = min_lmbda
        self.max_lmbda = max_lmbda
        self.mult_lmbda = mult_lmbda
        self.reg = reg
        self.min_imp = min_imp
        self.tolfun = tolfun
        self.tolgrad = tolgrad

        # reference belief trajectory
        self.bref_mu = jnp.zeros((nb_steps + 1, self.belief_dim)).at[0].set(self.mu0)
        self.bref_sigma = (
            jnp.tile(jnp.eye(self.belief_dim), (nb_steps + 1, 1, 1))
            .at[0]
            .set(self.sigma0)
        )
        self.uref = jnp.zeros((nb_steps, self.act_dim))

        key = jax.random.PRNGKey(0) if key is None else key
        self.ctl = LinearPolicy(
            K=jnp.zeros((nb_steps, self.act_dim, self.belief_dim)),
            kff=1e-8 * jax.random.normal(key, (nb_steps, self.act_dim)),
        )

        self.vfunc = None
        self.last_return = -np.inf

        self._expand = jax.jit(self._expand_impl)
        self._backward = jax.jit(
            lambda cost, dyn, lm: bsp_backward(cost, dyn, lm, self.reg)
        )
        self._forward_all = jax.jit(self._forward_all_impl)

    # ------------------------------------------------------------------ jitted cores
    def _forward_all_impl(self, ctl, bref_mu, uref):
        """Belief rollouts under the tracking law u = uref + α kff + K (μ − μref)
        for the whole α-grid at once (bspilqr.py:76-88, 177-190; action law
        bspilqr/objects.py:280-282)."""
        T = self.nb_steps

        def one(alpha):
            def step(carry, inp):
                mu, sigma = carry
                K, kff, mu_ref, u_ref = inp
                u = u_ref + alpha * kff + K @ (mu - mu_ref)
                c = self.env.cost(mu, sigma, u)
                f, _, phi = belief_ekf_step(self.env, mu, sigma, u)
                return (f, phi), (mu, sigma, u, c)

            inputs = (ctl.K, ctl.kff, bref_mu[:T], uref)
            (mu_T, sig_T), (mus, sigmas, us, cs) = lax.scan(
                step, (self.mu0, self.sigma0), inputs
            )
            c_T = self.env.cost(mu_T, sig_T, jnp.zeros(self.act_dim, mu_T.dtype))
            return (
                jnp.concatenate([mus, mu_T[None]], axis=0),
                jnp.concatenate([sigmas, sig_T[None]], axis=0),
                us,
                jnp.concatenate([cs, c_T[None]], axis=0),
            )

        return jax.vmap(one)(self.alphas)

    def _expand_impl(self, bref_mu, bref_sigma, uref):
        T = self.nb_steps
        dyn = belief_dynamics_expansion(self.env, bref_mu[:T], bref_sigma[:T], uref)
        cost = belief_cost_expansion(self.env, bref_mu, bref_sigma, uref)
        return cost, dyn

    # ------------------------------------------------------------------ main loop
    def plot(self, show: bool = True):
        """Belief trajectory with ±2σ bands (bspilqr/bspilqr.py:106-125)."""
        from ..utils.viz import plot_belief_trajectory

        return plot_belief_trajectory(
            self.bref_mu, self.bref_sigma, self.uref, show=show
        )

    def run(self, nb_iter: int = 25, verbose: bool = False) -> list[float]:
        from ..utils.metrics import MetricsRecorder
        self.metrics = MetricsRecorder("bspilqr")  # fresh history per run
        trace = []

        # init trajectory over the α-grid (bspilqr.py:129-137)
        mus_all, sigmas_all, us_all, costs_all = jax.device_get(
            self._forward_all(self.ctl, self.bref_mu, self.uref)
        )
        for i in range(len(mus_all)):
            if np.all(mus_all[i] < 1e8):
                self.bref_mu = jnp.asarray(mus_all[i])
                self.bref_sigma = jnp.asarray(sigmas_all[i])
                self.uref = jnp.asarray(us_all[i])
                self.last_return = float(np.sum(costs_all[i]))
                break
            print("Initial trajectory diverges")
        trace.append(self.last_return)
        self.metrics.log(-1, ret=self.last_return, accepted=True,
                         lmbda=self.lmbda)

        for it in range(nb_iter):
            cost, dyn = self._expand(self.bref_mu, self.bref_sigma, self.uref)

            backpass_done = False
            lc = S = s = tau = dS = None
            while not backpass_done:
                lc, S, s, tau, dS, diverged = self._backward(cost, dyn, self.lmbda)
                if bool(diverged):
                    self.dlmbda = max(self.dlmbda * self.mult_lmbda, self.mult_lmbda)
                    self.lmbda = max(self.lmbda * self.dlmbda, self.min_lmbda)
                    if self.lmbda > self.max_lmbda:
                        break
                else:
                    backpass_done = True

            kff = np.asarray(lc.kff)
            uref = np.asarray(self.uref)
            g_norm = np.mean(np.max(np.abs(kff) / (np.abs(uref) + 1.0), axis=0))
            if g_norm < self.tolgrad and self.lmbda < 1e-5:
                self.dlmbda = min(self.dlmbda / self.mult_lmbda, 1.0 / self.mult_lmbda)
                self.lmbda = self.lmbda * self.dlmbda * (self.lmbda > self.min_lmbda)
                break

            fwdpass_done = False
            accepted = None
            if backpass_done:
                mus_all, sigmas_all, us_all, costs_all = jax.device_get(
                    self._forward_all(lc, self.bref_mu, self.uref)
                )
                dS_np = np.asarray(dS)
                for i, alpha in enumerate(np.asarray(self.alphas)):
                    ret = float(np.sum(costs_all[i]))
                    dreturn = self.last_return - ret
                    expected = -1.0 * alpha * (dS_np[0] + alpha * dS_np[1])
                    with np.errstate(divide="ignore", invalid="ignore"):
                        imp = dreturn / expected
                    if imp > self.min_imp:
                        fwdpass_done = True
                        accepted = (mus_all[i], sigmas_all[i], us_all[i], ret, dreturn)
                        break

            if fwdpass_done:
                self.dlmbda = min(self.dlmbda / self.mult_lmbda, 1.0 / self.mult_lmbda)
                self.lmbda = self.lmbda * self.dlmbda * (self.lmbda > self.min_lmbda)

                mus, sigmas, us, ret, dreturn = accepted
                self.bref_mu = jnp.asarray(mus)
                self.bref_sigma = jnp.asarray(sigmas)
                self.uref = jnp.asarray(us)
                self.last_return = ret
                self.vfunc = (S, s, tau)
                self.ctl = lc
                trace.append(ret)

                self.metrics.log(it, ret=ret, dreturn=dreturn,
                                 lmbda=self.lmbda, g_norm=g_norm, accepted=True)
                if verbose:
                    print(self.metrics.format_last())

                if dreturn < self.tolfun:
                    break
            else:
                self.dlmbda = max(self.dlmbda * self.mult_lmbda, self.mult_lmbda)
                self.lmbda = max(self.lmbda * self.dlmbda, self.min_lmbda)
                self.metrics.log(it, lmbda=self.lmbda, g_norm=g_norm,
                                 accepted=False)
                if self.lmbda > self.max_lmbda:
                    break

        return trace
