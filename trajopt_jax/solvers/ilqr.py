"""iLQR with Levenberg-Marquardt regularization and backtracking line search.

JAX re-implementation of ``trajopt.ilqr.iLQR`` (ilqr/ilqr.py:10-237).  The three
hot paths of the reference become compiled device programs:

* per-t autograd linearization loops (ilqr/objects.py:68-78, 114-117) → one vmapped
  jacfwd/hessian call over the horizon (core/diff.py);
* the C++ regularized Riccati backward pass (ilqr/src/util.cpp:83-182) → a
  ``lax.scan`` kernel (core/scan_lqr.ilqr_backward);
* the sequential backtracking line search (ilqr.py:185-201) → a single ``vmap`` over
  the full α-grid; the host then accepts the first candidate in grid order, preserving
  the reference's acceptance semantics exactly.

The outer accept/reject and λ-escalation logic runs on host with numpy scalars, exactly
mirroring ilqr/ilqr.py:136-237 (including λ-zeroing below ``min_lmbda``).  A fully
jitted MPC driver lives in ``parallel/mpc.py``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.diff import linearize_dynamics_delta, quadratize_cost_delta
from ..core.scan_lqr import ilqr_backward
from ..core.types import LinearPolicy, QuadraticQValue, QuadraticValue
from .common import DEFAULT_ALPHAS, make_weighting, rollout_tracking_all_alphas


class iLQR:

    def __init__(
        self,
        env,
        nb_steps: int,
        init_state,
        activation: dict | None = None,
        slew_rate: bool = False,
        action_penalty=None,
        alphas=DEFAULT_ALPHAS,
        lmbda: float = 1.0,
        dlmbda: float = 1.0,
        min_lmbda: float = 1e-6,
        max_lmbda: float = 1e6,
        mult_lmbda: float = 1.6,
        tolfun: float = 1e-6,
        tolgrad: float = 1e-4,
        min_imp: float = 0.0,
        reg: int = 1,
        key=None,
    ):
        # the reference mutates env.unwrapped in place (ilqr.py:34-36); envs here are
        # immutable, so build a re-parameterized copy
        overrides = {"slew_rate": slew_rate}
        if action_penalty is not None:
            overrides["uw"] = tuple(
                float(action_penalty) for _ in range(env.dm_act)
            )
        self.env = env.replace(**overrides)

        self.nb_steps = nb_steps
        self.dm_state = env.dm_state
        self.dm_act = env.dm_act

        self.alphas = jnp.asarray(alphas)
        self.alpha = None

        self.lmbda = lmbda
        self.dlmbda = dlmbda
        self.min_lmbda = min_lmbda
        self.max_lmbda = max_lmbda
        self.mult_lmbda = mult_lmbda
        self.reg = reg
        self.min_imp = min_imp
        self.tolfun = tolfun
        self.tolgrad = tolgrad

        self.weighting = make_weighting(nb_steps, activation)

        self.xref = jnp.zeros((nb_steps + 1, self.dm_state)).at[0].set(
            jnp.asarray(init_state)
        )
        self.uref = jnp.zeros((nb_steps, self.dm_act))

        # small random feedforward init (ilqr.py:70)
        key = jax.random.PRNGKey(0) if key is None else key
        kff0 = 1e-4 * jax.random.normal(key, (nb_steps, self.dm_act))
        self.ctl = LinearPolicy(
            K=jnp.zeros((nb_steps, self.dm_act, self.dm_state)), kff=kff0
        )

        self.vfunc: QuadraticValue | None = None
        self.qfunc: QuadraticQValue | None = None
        self.last_return = -np.inf

        from ..utils.metrics import MetricsRecorder
        self.metrics = MetricsRecorder("ilqr")

        self._expand = jax.jit(self._expand_impl)
        self._backward = jax.jit(partial(ilqr_backward, reg=self.reg))
        self._forward_all = jax.jit(self._forward_all_impl)

    # ------------------------------------------------------------------ jitted cores
    def _expand_impl(self, xref, uref):
        T = self.nb_steps
        A, B = linearize_dynamics_delta(self.env.dynamics, xref[:T], uref)
        cost = quadratize_cost_delta(self.env.cost, xref, uref, self.weighting)
        return A, B, cost

    def _forward_all_impl(self, ctl, xref, uref):
        return rollout_tracking_all_alphas(
            self.env, ctl, self.alphas, xref[0], xref, uref, self.weighting
        )

    # ------------------------------------------------------------------ public API
    def forward_pass(self, ctl: LinearPolicy, alpha: float):
        from .common import rollout_tracking

        return rollout_tracking(
            self.env, ctl, alpha, self.xref[0], self.xref, self.uref, self.weighting
        )

    def backward_pass(self):
        A, B, cost = self._expand(self.xref, self.uref)
        return self._backward(cost, A, B, self.lmbda)

    def plot(self, show: bool = True):
        """Reference-trajectory plot (ilqr/ilqr.py:119-134)."""
        from ..utils.viz import plot_reference_trajectory

        return plot_reference_trajectory(self.xref, self.uref, show=show)

    def run(self, nb_iter: int = 25, verbose: bool = False) -> list[float]:
        self.metrics.reset()  # history describes the latest run
        trace = []

        # --- init trajectory: first finite candidate over the α-grid (ilqr.py:139-148)
        states_all, actions_all, costs_all = jax.device_get(
            self._forward_all(self.ctl, self.xref, self.uref)
        )
        for i in range(len(states_all)):
            if np.all(states_all[i] < 1e8):
                self.xref = jnp.asarray(states_all[i])
                self.uref = jnp.asarray(actions_all[i])
                self.last_return = float(np.sum(costs_all[i]))
                break
            print("Initial trajectory diverges")
        trace.append(self.last_return)
        self.metrics.log(-1, ret=self.last_return, accepted=True,
                         lmbda=self.lmbda)

        for it in range(nb_iter):
            A, B, cost = self._expand(self.xref, self.uref)

            # --- backward pass with λ escalation (ilqr.py:160-173)
            backpass_done = False
            lc = value = qvalue = dV = None
            while not backpass_done:
                lc, value, qvalue, dV, diverged = self._backward(cost, A, B, self.lmbda)
                if bool(diverged):
                    self.dlmbda = max(self.dlmbda * self.mult_lmbda, self.mult_lmbda)
                    self.lmbda = max(self.lmbda * self.dlmbda, self.min_lmbda)
                    if self.lmbda > self.max_lmbda:
                        break
                else:
                    backpass_done = True

            # --- gradient-norm termination (ilqr.py:176-180)
            kff = np.asarray(lc.kff)              # (T, du)
            uref = np.asarray(self.uref)
            g_norm = np.mean(np.max(np.abs(kff) / (np.abs(uref) + 1.0), axis=0))
            if g_norm < self.tolgrad and self.lmbda < 1e-5:
                self.dlmbda = min(self.dlmbda / self.mult_lmbda, 1.0 / self.mult_lmbda)
                self.lmbda = self.lmbda * self.dlmbda * (self.lmbda > self.min_lmbda)
                break

            # --- line search over the α-grid, all candidates in parallel
            fwdpass_done = False
            accepted = None
            if backpass_done:
                states_all, actions_all, costs_all = jax.device_get(
                    self._forward_all(lc, self.xref, self.uref)
                )
                dV_np = np.asarray(dV)
                for i, alpha in enumerate(np.asarray(self.alphas)):
                    ret = float(np.sum(costs_all[i]))
                    dreturn = self.last_return - ret
                    expected = -1.0 * alpha * (dV_np[0] + alpha * dV_np[1])
                    with np.errstate(divide="ignore", invalid="ignore"):
                        imp = dreturn / expected
                    if imp >= self.min_imp:
                        fwdpass_done = True
                        self.alpha = float(alpha)
                        accepted = (states_all[i], actions_all[i], ret, dreturn)
                        break

            # --- accept / reject (ilqr.py:204-231)
            if fwdpass_done:
                self.dlmbda = min(self.dlmbda / self.mult_lmbda, 1.0 / self.mult_lmbda)
                self.lmbda = self.lmbda * self.dlmbda * (self.lmbda > self.min_lmbda)

                states, actions, ret, dreturn = accepted
                self.xref = jnp.asarray(states)
                self.uref = jnp.asarray(actions)
                self.last_return = ret
                self.vfunc, self.qfunc, self.ctl = value, qvalue, lc
                trace.append(self.last_return)

                self.metrics.log(it, ret=ret, dreturn=dreturn,
                                 lmbda=self.lmbda, g_norm=g_norm,
                                 alpha=self.alpha, accepted=True)
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
