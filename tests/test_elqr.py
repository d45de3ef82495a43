import numpy as np
import pytest

import trajopt_jax
from trajopt_jax.solvers.elqr import eLQR


def _reference_elqr_lqr(T=60, nb_iter=10, seed=0):
    """Pure-numpy replica of the reference eLQR formulas (elqr/elqr.py:67-160,
    elqr/objects.py:56-73) on the LQR-v0 task — the port-parity oracle.

    Note: the reference pairs an exact discrete map `dynamics` with a backward-RK4
    `inverse_dynamics` that is *not* its exact inverse (envs/lqr/lqr_v0.py:50-82),
    so eLQR's converged cost on this task differs from the Riccati optimum by
    construction.  Parity means matching the reference's fixed point, not Riccati's.
    """
    A = np.array([[1.1, 0.0], [1.0, 1.0]])
    B = np.array([[1.0], [0.0]])
    g = np.array([10.0, 10.0])
    c = -A @ g
    dt = 0.1
    gw = np.diag([10.0, 10.0])
    uw = np.diag([1.0])
    x0 = np.array([5.0, 5.0])
    dx, du = 2, 1

    def cost(x, u):
        return dt * (u @ uw @ u + (x - g) @ gw @ (x - g))

    def quadratize(x, u):
        H_xx, H_uu = 2 * dt * gw, 2 * dt * uw
        H_xu = np.zeros((dx, du))
        g_x = 2 * dt * gw @ (x - g)
        g_u = 2 * dt * uw @ u
        Cxx, Cuu, Cxu = 0.5 * H_xx, 0.5 * H_uu, H_xu
        cx = g_x - H_xx @ x - H_xu @ u
        cu = g_u - H_uu @ u - H_xu.T @ x
        c0 = cost(x, u) - x @ Cxx @ x - u @ Cuu @ u - x @ Cxu @ u - cx @ x - cu @ u
        return Cxx, Cuu, Cxu, cx, cu, c0

    def dyn(x, u):
        return A @ x + B @ u + c

    def idyn(x, u):
        k1 = dyn(x, u)
        k2 = dyn(x - 0.5 * dt * k1, u)
        k3 = dyn(x - 0.5 * dt * k2, u)
        k4 = dyn(x - dt * k3, u)
        return x - dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    def lin(f, x, u):
        f0 = f(np.zeros(dx), np.zeros(du))
        Af = np.stack(
            [f(np.eye(dx)[i], np.zeros(du)) - f0 for i in range(dx)], axis=1
        )
        Bf = np.stack(
            [f(np.zeros(dx), np.eye(du)[i]) - f0 for i in range(du)], axis=1
        )
        return Af, Bf, f0

    rng = np.random.default_rng(seed)
    K = np.zeros((T, du, dx))
    kff = rng.standard_normal((T, du))
    iK = np.zeros((T, du, dx))
    ikff = 1e-2 * rng.standard_normal((T, du))
    goV = np.zeros((T + 1, dx, dx))
    gov = np.zeros((T + 1, dx))
    gov0 = np.zeros(T + 1)
    comeV = np.zeros((T + 1, dx, dx))
    comev = np.zeros((T + 1, dx))
    comev0 = np.zeros(T + 1)
    goV[0] += 1e-16 * np.eye(dx)
    comeV[0] += 1e-16 * np.eye(dx)

    def forward_pass():
        x = x0.copy()
        total = 0.0
        for t in range(T):
            u = kff[t] + K[t] @ x
            total += cost(x, u)
            x = dyn(x, u)
        return total + cost(x, np.zeros(du))

    state = x0.copy()
    trace = [forward_pass()]
    for _ in range(nb_iter):
        for t in range(T):
            u = kff[t] + K[t] @ state
            xn = dyn(state, u)
            _A, _B, _c = lin(idyn, xn, u)
            Cxx, Cuu, Cxu, cx, cu, c0 = quadratize(state, u)
            M = Cxx + comeV[t]
            Qxx = _A.T @ M @ _A
            Quu = _B.T @ M @ _B + _B.T @ Cxu + Cxu.T @ _B + Cuu
            Qux = _B.T @ M @ _A + Cxu.T @ _A
            qx = _A.T @ M @ _c + _A.T @ (cx + comev[t])
            qu = _B.T @ M @ _c + Cxu.T @ _c + _B.T @ (cx + comev[t]) + cu
            q0 = 0.5 * _c @ M @ _c + _c @ (cx + comev[t]) + c0 + comev0[t]
            Qi = np.linalg.inv(Quu)
            iK[t], ikff[t] = -Qi @ Qux, -Qi @ qu
            comeV[t + 1] = Qxx - Qux.T @ Qi @ Qux
            comev[t + 1] = qx - Qux.T @ Qi @ qu
            comev0[t + 1] = q0 - 0.5 * qu @ Qi @ qu
            state = -np.linalg.inv(goV[t + 1] + comeV[t + 1]) @ (
                gov[t + 1] + comev[t + 1]
            )

        Cxx, Cuu, Cxu, cx, cu, c0 = quadratize(state, np.zeros(du))
        goV[T], gov[T], gov0[T] = Cxx, cx, c0
        state = -np.linalg.inv(goV[T] + comeV[T]) @ (gov[T] + comev[T])
        for t in range(T - 1, -1, -1):
            u = ikff[t] + iK[t] @ state
            xn = idyn(state, u)
            _A, _B, _c = lin(dyn, xn, u)
            Cxx, Cuu, Cxu, cx, cu, c0 = quadratize(xn, u)
            Qxx = Cxx + _A.T @ goV[t + 1] @ _A
            Quu = Cuu + _B.T @ goV[t + 1] @ _B
            Qux = Cxu.T + _B.T @ goV[t + 1] @ _A
            qx = cx + _A.T @ goV[t + 1] @ _c + _A.T @ gov[t + 1]
            qu = cu + _B.T @ goV[t + 1] @ _c + _B.T @ gov[t + 1]
            q0 = c0 + gov0[t + 1] + 0.5 * _c @ goV[t + 1] @ _c + _c @ gov[t + 1]
            Qi = np.linalg.inv(Quu)
            K[t], kff[t] = -Qi @ Qux, -Qi @ qu
            goV[t] = Qxx - Qux.T @ Qi @ Qux
            gov[t] = qx - Qux.T @ Qi @ qu
            gov0[t] = q0 - 0.5 * qu @ Qi @ qu
            state = -np.linalg.inv(goV[t] + comeV[t]) @ (gov[t] + comev[t])
        trace.append(forward_pass())
    return trace


def test_elqr_matches_reference_fixed_point_on_lqr():
    ref_trace = _reference_elqr_lqr()

    env = trajopt_jax.make("LQR-TO-v0")
    alg = eLQR(env, nb_steps=60, init_state=np.array(env.x0))
    trace = alg.run(nb_iter=10)

    # both must converge to the same fixed point (initializations differ randomly,
    # so only the converged value is compared)
    np.testing.assert_allclose(trace[-1], ref_trace[-1], rtol=1e-6)
    # fixed point is stable: last iterations identical
    np.testing.assert_allclose(trace[-1], trace[-3], rtol=1e-8)


def test_elqr_pendulum_improves():
    env = trajopt_jax.make("Pendulum-TO-v0")
    alg = eLQR(env, nb_steps=100, init_state=np.array(env.x0))
    trace = alg.run(nb_iter=10)
    assert np.isfinite(trace[-1])
    assert trace[-1] < 0.75 * trace[0]


def test_compiled_elqr_matches_host():
    """The one-program compiled eLQR (parallel/elqr.py) must reproduce the
    host-loop class exactly (same sweeps, same controller init)."""
    import jax
    import jax.numpy as jnp

    import trajopt_jax
    from trajopt_jax.parallel.elqr import make_elqr_solver
    from trajopt_jax.solvers.elqr import eLQR

    env = trajopt_jax.make("Pendulum-TO-v0", dt=0.01).replace(uw=(1e-3,))
    x0 = jnp.asarray(env.x0)

    host = eLQR(env, nb_steps=40, init_state=x0, key=jax.random.PRNGKey(0))
    host_trace = host.run(nb_iter=8)

    solve = jax.jit(make_elqr_solver(env, nb_steps=40, nb_iter=8))
    ctl, xs, us, trace = solve(jax.random.PRNGKey(0), x0)

    np.testing.assert_allclose(np.asarray(trace), np.asarray(host_trace), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(us), np.asarray(host.uref), rtol=1e-6,
                               atol=1e-9)

    # vmappable over seeds — the batched-eLQR capability the reference lacks
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    _, _, _, traces = jax.jit(jax.vmap(lambda k: solve(k, x0)))(keys)
    assert traces.shape == (3, 9)
    assert np.all(np.isfinite(np.asarray(traces)))
