"""Differentiable batched iLQR — ``jax.grad`` through the converged solve.

The reference cannot differentiate through its solver at all: ``iLQR.run`` is a
Python loop around opaque pybind/Armadillo kernels (ilqr/ilqr.py:136-237), so
losses defined on the solution (imitation error, task cost under learned
weights) have no gradient path to the problem parameters.  Here the whole
solve is one XLA program built from reverse-differentiable primitives
(:func:`trajopt_jax.parallel.mpc.make_ilqr_solver_batched` with
``differentiable=True``), which turns inverse optimal control /
differentiable-MPC-style learning (cf. Amos, Rodriguez, Sacks, Boots &
Kolter, "Differentiable MPC for End-to-end Planning and Control", NeurIPS
2018 — by unrolled algorithm differentiation rather than an implicit KKT
solve) into plain ``jax.grad``:

* gradients w.r.t. the initial states ``x0s`` flow through rollout dynamics,
  linearizations (second-order AD through ``jacfwd``/``hessian``) and the
  backward recursions;
* gradients w.r.t. ENVIRONMENT parameters (cost weights, goals, physical
  constants) flow by rebuilding the frozen-dataclass env with traced leaves
  inside the jitted program (``env.replace(gw=params)`` — every env method is
  a pure function of its fields, envs/base.py).

The gradient is the exact derivative of the executed algorithm (fixed
``nb_iter`` outer iterations, ``lm_steps``-bounded λ escalation, first-accept
α selection); as the iterates converge it approaches the implicit derivative
of the iLQR fixed point.

Differentiability across the compiled-solver family (all FD-pinned in
tests/test_diffmpc.py where claimed):

* **iLQR** — via ``differentiable=True`` (this module's wrapper);
* **belief-space iLQR** — via ``make_bsp_solver(differentiable=True)``
  (:mod:`..bsp`): the same bounded-λ-scan rewrite, giving planning
  sensitivities through the EKF belief dynamics (e.g. w.r.t. the light-dark
  observation-noise geometry);
* **eLQR** (:func:`..elqr.make_elqr_solver`) and **exact Riccati LQR**
  (:func:`..riccati.make_riccati_solver_batched`) — reverse-differentiable
  out of the box: their compiled programs are scans/linearizations only;
* **GPS** — via ``make_mbgps_solver(differentiable=True)``: the compiled dual
  solves the KL constraint by log-space *bisection*, which is
  piecewise-constant in its inputs, so plain algorithmic differentiation
  drops the dα*/dθ sensitivity; the differentiable mode restores it exactly
  with a ``custom_vjp`` implicit-function-theorem pass on KL(α*)=ε (scalar
  dual; primal bit-identical).
"""

from __future__ import annotations

from typing import Callable

from jax import Array

from .mpc import make_ilqr_solver_batched


def make_ilqr_solver_diff(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    param_apply: Callable | None = None,
    lm_steps: int = 16,
    **ilqr_kwargs,
):
    """Differentiable batch iLQR: ``solve(x0s (N, dx), params) -> (state, trace)``.

    ``param_apply(env, params) -> env`` injects traced parameters into the
    environment (typically ``lambda e, p: e.replace(gw=p)``); pass ``None``
    for an x0-only differentiable solve (``params`` is then ignored and may
    be omitted).  Both returned pytrees are reverse-differentiable in ``x0s``
    and ``params``; see ``make_ilqr_solver_batched(differentiable=True)`` for
    the (semantics-preserving) deviations from the default compiled solver.
    """

    def solve(x0s: Array, params=None):
        e = env if param_apply is None else param_apply(env, params)
        inner = make_ilqr_solver_batched(
            e,
            nb_steps,
            nb_iter=nb_iter,
            differentiable=True,
            lm_steps=lm_steps,
            **ilqr_kwargs,
        )
        return inner(x0s)

    return solve
