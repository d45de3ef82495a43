import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.core.scan_lqr import riccati_backward
from trajopt_jax.core.types import LinearDynamics, QuadraticCost
from trajopt_jax.solvers.riccati import Riccati

from ref_impl import random_quadratic_problem, riccati_backward_np


def test_riccati_backward_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    p = random_quadratic_problem(rng, T=37, dx=3, du=2)

    K_np, kff_np, V_np, v_np = riccati_backward_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"], p["c"]
    )

    cost = QuadraticCost(
        Cxx=jnp.asarray(p["Cxx"]), cx=jnp.asarray(p["cx"]),
        Cuu=jnp.asarray(p["Cuu"]), cu=jnp.asarray(p["cu"]),
        Cxu=jnp.asarray(p["Cxu"]), c0=jnp.asarray(p["c0"]),
    )
    dyn = LinearDynamics(A=jnp.asarray(p["A"]), B=jnp.asarray(p["B"]), c=jnp.asarray(p["c"]))
    ctl, value = riccati_backward(cost, dyn)

    np.testing.assert_allclose(np.asarray(ctl.K), K_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ctl.kff), kff_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.V), V_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.v), v_np, rtol=1e-9, atol=1e-9)


def test_riccati_lqr_converges_to_optimum():
    """Golden test: on the analytic LQR env, the solver must reproduce the exact
    optimal LQR cost computed by an independent NumPy dynamic-programming solve."""
    env = trajopt_jax.make("LQR-TO-v0")
    T = 60
    solver = Riccati(env, nb_steps=T, init_state=env.init())
    c1 = solver.run()
    # second sweep re-linearizes around the new trajectory: identical linear system
    # (exactly linear env) -> identical policy and cost (idempotency)
    c2 = solver.run()
    assert np.isfinite(c1)
    assert abs(c1 - c2) < 1e-8 * max(1.0, abs(c1))

    # independent exact solve: build the true quadratics of the linear env by hand
    A = np.array([[1.1, 0.0], [1.0, 1.0]])
    B = np.array([[1.0], [0.0]])
    g = np.asarray(env.g)
    c = -A @ g
    dt, gw, uw = env.dt, np.diag(np.asarray(env.gw)), np.diag(np.asarray(env.uw))

    Cxx = np.stack([dt * gw] * (T + 1))
    cx = np.stack([-2.0 * dt * gw @ g] * (T + 1))
    Cuu = np.stack([dt * uw] * (T + 1))
    cu = np.zeros((T + 1, 1))
    Cxu = np.zeros((T + 1, 2, 1))
    As, Bs, cs = np.stack([A] * T), np.stack([B] * T), np.stack([c] * T)

    K, kff, V, v = riccati_backward_np(Cxx, cx, Cuu, cu, Cxu, As, Bs, cs)

    # numpy rollout under the exact-optimal controller
    x = np.asarray(env.x0)
    total = 0.0
    for t in range(T):
        u = kff[t] + K[t] @ x
        total += dt * (u @ uw @ u + (x - g) @ gw @ (x - g))
        x = A @ x + B @ u + c
    total += dt * ((x - g) @ gw @ (x - g))

    np.testing.assert_allclose(c2, total, rtol=1e-8)


def test_riccati_cost_matches_value_function_prediction():
    """V(x0) from the backward pass equals the realized quadratic cost along the
    rollout (deterministic env, exact linear dynamics) — Bellman consistency."""
    env = trajopt_jax.make("LQR-TO-v0")
    solver = Riccati(env, nb_steps=60, init_state=env.init())
    solver.run()
    realized = solver.run()  # cost of rollout under the optimal policy

    x0 = np.asarray(solver.xref[0])
    V0 = np.asarray(solver.vfunc.V[0])
    v0 = np.asarray(solver.vfunc.v[0])
    predicted = x0 @ V0 @ x0 + v0 @ x0

    # the quadratization drops a state-independent constant (c0 is not tracked by the
    # riccati value recursion) -> compare cost *differences* from two starts instead
    env2 = env
    solver2 = Riccati(env2, nb_steps=60, init_state=(jnp.asarray([2.0, -1.0]), env.init()[1]))
    solver2.run()
    realized2 = solver2.run()

    x0b = np.asarray(solver2.xref[0])
    predicted2 = x0b @ V0 @ x0b + v0 @ x0b

    np.testing.assert_allclose(
        realized - realized2, predicted - predicted2, rtol=5e-2
    )


def test_batched_riccati_solver_matches_host():
    """Batch-native Riccati (parallel/riccati.py, scan engine on CPU) must match
    the host Riccati class per instance."""
    from trajopt_jax.parallel.riccati import make_riccati_solver_batched
    from trajopt_jax.solvers import Riccati

    env = trajopt_jax.make("LQR-TO-v0")
    solve = jax.jit(make_riccati_solver_batched(env, nb_steps=40))
    mu0, _ = env.init()
    x0s = jnp.asarray(mu0) + jnp.asarray([[0.0, 0.0], [0.3, -0.2], [-0.5, 0.1]])

    ctl, states, actions, costs, div = solve(x0s)
    assert not np.any(np.asarray(div))

    for i in range(3):
        host = Riccati(env, nb_steps=40, init_state=(np.asarray(x0s[i]), env.init()[1]))
        c_host = host.run()
        np.testing.assert_allclose(float(jnp.sum(costs[i])), c_host, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(ctl.K[i]), np.asarray(host.ctl.K),
                                   rtol=1e-8, atol=1e-10)
