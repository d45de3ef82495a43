"""Headline benchmark: iLQR iterations/sec at horizon 1000 + per-config extras.

Runs on an NVIDIA GPU and refuses any other device.

BASELINE.json metric: "Riccati backward-pass timesteps/sec/chip; iLQR iters/sec at
horizon 1000".  The reference publishes no numbers (BASELINE.md), so the baseline is
*measured*: the identical backward pass as single-thread -O3 -march=native C++ on
this host's CPU (native/baseline.cpp — the role the reference's Armadillo/OpenBLAS
kernel plays, which itself is explicitly single-threaded, README.md:20).

Headline: **full iLQR iterations/sec at horizon 1000** (cartpole swing-up, dx=4) —
each iteration is the complete linearize → λ-escalated backward pass → α-grid line
search → accept/reject of ilqr/ilqr.py:136-237, compiled as one device program with
the batch axis primal (parallel/mpc.make_ilqr_solver_batched) on the engines
``HEADLINE_ENGINES`` names.  ``vs_baseline`` is CONSERVATIVE: the CPU denominator is
the C++ *backward pass alone* at T=1000 (one per iteration) — the reference's real
iteration adds per-t autograd linearization and Python rollout loops on top, so the
true ratio is larger.

Extras cover the remaining BASELINE.md configs: the backward-kernel timesteps/s,
Riccati LQR at horizon 100, eLQR cartpole iterations/s, BSP-iLQR light-dark MPC
steps/s, the batched belief backward, the batched GPS dual-evaluation chain and the
RGPS adversary fixed point.

Timing: host clock around ``block_until_ready`` on a warmed executable, median of
``REPEATS`` calls (utils/profiling.seconds_per_call); the row's min/max go into
``<row>_spread``.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extras"}.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def _problem(T, dx, du, batch, dtype=None):
    """dtype=None returns plain numpy float64 (for the native baseline)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)

    def spd(d, n):
        M = rng.standard_normal((n, d, d))
        return np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    A = 0.97 * (np.eye(dx) + 0.05 * rng.standard_normal((T, dx, dx)))
    B = 0.1 * rng.standard_normal((T, dx, du))
    p = dict(
        Cxx=spd(dx, T + 1),
        cx=rng.standard_normal((T + 1, dx)),
        Cuu=spd(du, T + 1),
        cu=rng.standard_normal((T + 1, du)),
        Cxu=0.1 * rng.standard_normal((T + 1, dx, du)),
        c0=np.zeros(T + 1),
        A=A,
        B=B,
        c=0.01 * rng.standard_normal((T, dx)),
    )
    if batch:
        p = {k: np.broadcast_to(v, (batch,) + v.shape).copy() for k, v in p.items()}
        # decorrelate instances slightly so XLA can't fold the batch
        p["cx"] = p["cx"] + 0.01 * rng.standard_normal(p["cx"].shape)
    if dtype is None:
        return p
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


SPREADS = {}  # row name -> (lo, hi) rate over the timed repeats
REPEATS = 5
# the engines the headline runs: the pair chip_smoke.py checks and times
HEADLINE_ENGINES = ("pallas", "pallas")


def _seconds(name, fn, args, rate_from_sec):
    """Median seconds per ``fn(*args)`` (jitted here); records the row's rate
    spread under ``name``."""
    import jax

    from trajopt_jax.utils.profiling import seconds_per_call

    sec, (lo, hi) = seconds_per_call(jax.jit(fn), args, REPEATS)
    SPREADS[name] = (round(rate_from_sec(hi), 1), round(rate_from_sec(lo), 1))
    return sec


def bench_ilqr_iters():
    """Headline: full iLQR iterations/sec at horizon 1000 (batched cartpole) on
    ``HEADLINE_ENGINES``.  Raises when the engine fails.  Returns
    (instance-iters/s, sec per batch-iter, engine tag, T, N)."""
    import jax.numpy as jnp

    import trajopt_jax
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_jax.make("Cartpole-TO-v0")
    T, N, nb_iter = 1000, 2048, 10
    x0 = jnp.zeros((N, env.dm_state), jnp.float32)
    x0 = x0.at[:, 0].add(0.01 * jnp.arange(N, dtype=jnp.float32))

    backward, rollout = HEADLINE_ENGINES
    solve = make_ilqr_solver_batched(
        env, T, nb_iter=nb_iter, backward=backward, rollout=rollout
    )
    sec = _seconds("headline", lambda x: solve(x)[0].last_return, (x0,),
                   lambda sc: N * nb_iter / sc)
    return (N * nb_iter / sec, sec / nb_iter,
            f"backward={backward},rollout={rollout}", T, N)


def _batch_lqr(T, dx, du, batch):
    """Batch-leading operands built ON DEVICE from one host instance (decorrelated
    so XLA can't fold the batch)."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.types import QuadraticCost

    one = {k: jnp.asarray(v, jnp.float32) for k, v in _problem(T, dx, du, 0).items()}

    def build(one):
        b = {k: jnp.broadcast_to(v, (batch,) + v.shape) for k, v in one.items()}
        cx = b["cx"] + 0.01 * jax.random.normal(
            jax.random.PRNGKey(0), b["cx"].shape, jnp.float32
        )
        cost = QuadraticCost(
            Cxx=b["Cxx"], cx=cx, Cuu=b["Cuu"], cu=b["cu"], Cxu=b["Cxu"], c0=b["c0"]
        )
        return cost, b["A"], b["B"], b["c"]

    return jax.block_until_ready(jax.jit(build)(one))


def bench_backward_packed(T, dx, du, batch):
    """The Pallas iLQR backward kernel on its packed (batch-minor) operands:
    timesteps/s."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.pallas_lqr import pack_batch, pallas_ilqr_backward_packed

    cost, A, B, _ = _batch_lqr(T, dx, du, batch)
    lam = jnp.zeros(batch, jnp.float32)
    packed = jax.block_until_ready(jax.jit(pack_batch)(cost, A, B, lam))
    sec = _seconds(
        f"ilqr_backward_tps@{batch}",
        lambda pk: pallas_ilqr_backward_packed(pk, dx, du, 1)[1], (packed,),
        lambda sc: batch * T / sc,
    )
    return batch * T / sec


def bench_riccati(T=100, batch=4096):
    """Riccati LQR recursion (BASELINE config #1): exact backward pass + gains at
    T=100, the Pallas kernel via the homogeneous-coordinate reduction
    (core/pallas_lqr.pallas_riccati_backward)."""
    from trajopt_jax.core.pallas_lqr import pallas_riccati_backward

    cost, A, B, c = _batch_lqr(T, 2, 1, batch)
    sec = _seconds(
        f"riccati_T{T}_tps@{batch}",
        lambda cost, A, B, c: pallas_riccati_backward(cost, A, B, c)[0].K,
        (cost, A, B, c), lambda sc: batch * T / sc,
    )
    return batch * T / sec


def bench_elqr(T=100, batch=64, nb_iter=10):
    """eLQR cartpole swing-up (BASELINE config #3): iterations/sec."""
    import jax
    import jax.numpy as jnp

    import trajopt_jax
    from trajopt_jax.parallel.elqr import make_elqr_solver_batched

    env = trajopt_jax.make("Cartpole-TO-v0")
    solve = make_elqr_solver_batched(env, T, nb_iter=nb_iter)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    x0s = jnp.zeros((batch, env.dm_state), jnp.float32)
    x0s = x0s.at[:, 1].add(0.001 * jnp.arange(batch, dtype=jnp.float32))
    sec = _seconds(f"elqr_cartpole_iters_per_s@{batch}",
                   lambda k, x: solve(k, x)[2], (keys, x0s),
                   lambda sc: batch * nb_iter / sc)
    return batch * nb_iter / sec


def bench_bsp(horizon=25, nb_steps=50, nb_iter=10):
    """BSP-iLQR light-dark MPC (BASELINE config #4): control steps/sec (replan +
    act + EKF update per step — the examples/bspilqr/lightdark.py loop)."""
    import jax
    import jax.numpy as jnp

    import trajopt_jax
    from trajopt_jax.parallel.bsp import make_bsp_mpc_runner

    env = trajopt_jax.make("LightDark-TO-v0")
    run = make_bsp_mpc_runner(env, horizon, nb_steps, nb_iter=nb_iter)
    mu0, _ = env.init()
    x0 = jnp.asarray(np.array(mu0), jnp.float32)
    key = jax.random.PRNGKey(1)
    sec = _seconds("bsp_lightdark_mpc_steps_per_s", lambda x: run(key, x)[3],
                   (x0,), lambda sc: nb_steps / sc)
    return nb_steps / sec


def _belief_problem(T, rng, b=2, a=2):
    """One random lightdark-dim belief problem (cost expansion + dynamics
    expansion, numpy float64) — shared by the device bench and the native CPU
    denominator so both time the exact same problem class."""
    from trajopt_jax.core.belief import (
        BeliefCostExpansion,
        BeliefDynamicsExpansion,
    )

    def spd(d, n, s=1.0):
        M = rng.standard_normal((n, d, d))
        return s * np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    cost = BeliefCostExpansion(
        Q=spd(b, T + 1), q=rng.standard_normal((T + 1, b)),
        R=spd(a, T + 1, 0.5), r=rng.standard_normal((T + 1, a)),
        P=0.1 * rng.standard_normal((T + 1, b, a)),
        p=rng.standard_normal((T + 1, b * b)),
    )
    dyn = BeliefDynamicsExpansion(
        F=np.broadcast_to(np.eye(b), (T, b, b))
          + 0.05 * rng.standard_normal((T, b, b)),
        G=0.1 * rng.standard_normal((T, b, a)),
        X=0.01 * rng.standard_normal((T, b * b, b)),
        Y=0.01 * rng.standard_normal((T, b * b, b * b)),
        Z=0.01 * rng.standard_normal((T, b * b, a)),
        T=0.01 * rng.standard_normal((T, b * b, b)),
        U=0.01 * rng.standard_normal((T, b * b, b * b)),
        V=0.01 * rng.standard_normal((T, b * b, a)),
    )
    return cost, dyn


def bench_bsp_backward_batched(T=25, batch=4096):
    """Batched belief-value backward recursion (vec-channel Riccati) — the
    BASELINE protocol's backward-pass ts/s for the bspilqr config over a batch
    of lightdark-dim problems (b=2, a=2), vmapped scan kernel."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.belief import bsp_backward

    one_cost, one_dyn = _belief_problem(T, np.random.default_rng(5))
    one = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), (one_cost, one_dyn))

    def build(one):
        cost, dyn = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one
        )
        q = cost.q + 0.01 * jax.random.normal(
            jax.random.PRNGKey(0), cost.q.shape, jnp.float32
        )  # decorrelate instances so XLA can't fold the batch
        return cost._replace(q=q), dyn

    cost, dyn = jax.block_until_ready(jax.jit(build)(one))
    lmbda = jnp.float32(0.1)

    def fn(cost, dyn):
        lc, *_ = jax.vmap(lambda c, d: bsp_backward(c, d, lmbda, 1))(cost, dyn)
        return lc.kff

    sec = _seconds(f"bsp_backward_tps@{batch}", fn, (cost, dyn),
                   lambda sc: batch * T / sc)
    return batch * T / sec


def _gps_dual_operands(T, dx, du, batch):
    """Batch-leading GPS dual operands, built ON DEVICE from one host instance."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.types import (
        LinearGaussianDynamics,
        LinearGaussianPolicy,
        QuadraticCost,
    )

    one = {k: jnp.asarray(v, jnp.float32) for k, v in _problem(T, dx, du, 0).items()}

    def build(one):
        b = {k: jnp.broadcast_to(v, (batch,) + v.shape) for k, v in one.items()}
        cx = b["cx"] + 0.01 * jax.random.normal(
            jax.random.PRNGKey(0), b["cx"].shape, jnp.float32
        )
        cost = QuadraticCost(
            Cxx=b["Cxx"], cx=cx, Cuu=b["Cuu"], cu=b["cu"], Cxu=b["Cxu"], c0=b["c0"]
        )
        dyn = LinearGaussianDynamics(
            A=b["A"], B=b["B"], c=b["c"],
            sigma=jnp.broadcast_to(1e-4 * jnp.eye(dx), (batch, T, dx, dx)).astype(
                jnp.float32
            ),
        )
        pol = LinearGaussianPolicy(
            K=0.1 * jax.random.normal(jax.random.PRNGKey(1), (batch, T, du, dx), jnp.float32),
            kff=0.1 * jax.random.normal(jax.random.PRNGKey(2), (batch, T, du), jnp.float32),
            sigma=jnp.broadcast_to(jnp.eye(du), (batch, T, du, du)).astype(
                jnp.float32
            ),
        )
        mu0 = jnp.zeros((batch, dx), jnp.float32)
        sig0 = jnp.broadcast_to(0.1 * jnp.eye(dx), (batch, dx, dx)).astype(jnp.float32)
        return cost, dyn, pol, mu0, sig0

    return jax.jit(build)(one)


def bench_gps_dual(T=1000, batch=4096):
    """Batched GPS dual-evaluation chain (BASELINE config #5): KL-augment + soft
    backward, then Gaussian forward + KL — the vmapped lax.scan chain the
    compiled solver's bisection loop runs."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.scan_lqr import (
        augment_cost_kl,
        gaussian_forward,
        gps_backward,
        policy_kl,
    )

    dx, du = 4, 2
    cost, dyn, pol, mu0, sig0 = _gps_dual_operands(T, dx, du, batch)
    alpha = jnp.full((batch, T), 10.0, jnp.float32)

    def dual_one(cost, dyn, pol, alpha, mu0, sig0):
        ag = augment_cost_kl(cost, pol, alpha)
        lgc, value, _, _ = gps_backward(ag, dyn, alpha)
        xdist, _, _ = gaussian_forward(dyn, lgc, mu0, sig0)
        kl = policy_kl(lgc, pol, jax.tree.map(lambda x: x[:-1], xdist))
        return jnp.sum(kl)

    sec = _seconds(f"gps_dual_eval_tps@{batch}", jax.vmap(dual_one),
                   (cost, dyn, pol, alpha, mu0, sig0), lambda sc: batch * T / sc)
    return batch * T / sec


def bench_rgps_fixed_point(T=100, batch=8):
    """RGPS adversary fixed-point trip (SURVEY §3.4, the reference's deepest hot
    path): one `parameter_backward_pass` (Kronecker-lifted MatrixNormal solve,
    rgps/src/util.cpp:626-798) + one `cubature_forward_pass` (util.cpp:232-361)
    + KL damping, vmapped over a batch of problems.  Returns timesteps/s."""
    import jax
    import jax.numpy as jnp

    from trajopt_jax.core.cubature import (
        cubature_forward_pass,
        parameter_augment_cost,
        parameter_backward_pass,
    )
    from trajopt_jax.core.scan_lqr import gaussian_interp_kl, gaussian_kl
    from trajopt_jax.core.types import (
        LinearGaussianPolicy,
        MatrixNormalParams,
        QuadraticCost,
    )

    dx, du = 4, 2
    p1 = dx + du + 1
    pdim = dx * p1
    one = {k: jnp.asarray(v, jnp.float32) for k, v in _problem(T, dx, du, 0).items()}

    def build(one):
        b = {k: jnp.broadcast_to(v, (batch,) + v.shape) for k, v in one.items()}
        cost = QuadraticCost(
            Cxx=b["Cxx"],
            cx=b["cx"] + 0.01 * jax.random.normal(
                jax.random.PRNGKey(0), b["cx"].shape, jnp.float32
            ),
            Cuu=b["Cuu"], cu=b["cu"], Cxu=b["Cxu"], c0=b["c0"],
        )
        # nominal parameter distribution around the true (A, B, c)
        theta = jnp.concatenate(
            [jnp.swapaxes(b["A"], -1, -2).reshape(batch, T, dx * dx),
             jnp.swapaxes(b["B"], -1, -2).reshape(batch, T, du * dx),
             b["c"]], axis=-1,
        )
        nominal = MatrixNormalParams(
            mu=theta,
            sigma=jnp.broadcast_to(
                1e-4 * jnp.eye(pdim), (batch, T, pdim, pdim)
            ).astype(jnp.float32),
        )
        ctl = LinearGaussianPolicy(
            K=0.05 * jax.random.normal(jax.random.PRNGKey(1), (batch, T, du, dx), jnp.float32),
            kff=0.05 * jax.random.normal(jax.random.PRNGKey(2), (batch, T, du), jnp.float32),
            sigma=jnp.broadcast_to(jnp.eye(du), (batch, T, du, du)).astype(
                jnp.float32
            ),
        )
        noise = jnp.broadcast_to(1e-4 * jnp.eye(dx), (batch, T, dx, dx)).astype(
            jnp.float32
        )
        mu0 = jnp.zeros((batch, dx), jnp.float32)
        sigma0 = jnp.broadcast_to(0.01 * jnp.eye(dx), (batch, dx, dx)).astype(
            jnp.float32
        )

        def prep(cost_i, nom_i, ctl_i, noise_i, mu0_i, sigma0_i):
            agCpp, agcp, _ = parameter_augment_cost(nom_i, jnp.float32(100.0))
            xdist0, _, _ = cubature_forward_pass(
                mu0_i, sigma0_i, nom_i, noise_i, ctl_i
            )
            return agCpp, agcp, xdist0

        agCpp, agcp, xdist0 = jax.vmap(prep)(cost, nominal, ctl, noise, mu0, sigma0)
        return cost, ctl, noise, mu0, sigma0, agCpp, agcp, xdist0

    operands = jax.block_until_ready(jax.jit(build)(one))
    beta = jnp.full((), 200.0, jnp.float32)

    def trip(cost, ctl, noise, mu0, sigma0, agCpp, agcp, q):
        def one_i(cost_i, ctl_i, noise_i, mu0_i, sigma0_i, aC, ac, q_i):
            param, _, _ = parameter_backward_pass(
                q_i, ctl_i, noise_i, cost_i, aC, ac, beta
            )
            p_xdist, _, _ = cubature_forward_pass(
                mu0_i, sigma0_i, param, noise_i, ctl_i
            )
            q_new = gaussian_interp_kl(q_i, p_xdist, 1e-1)
            return jnp.sum(gaussian_kl(p_xdist, q_i)), q_new

        return jax.vmap(one_i)(cost, ctl, noise, mu0, sigma0, agCpp, agcp, q)

    sec = _seconds(f"rgps_fixed_point_tps@{batch}", trip, operands,
                   lambda sc: batch * T / sc)
    return batch * T / sec


def bench_rgps_solve(T=60, nb_iter=2, beta_search="bisect"):
    """Full compiled robust-GPS solve (LQR-TO-v1, lr variant): outer
    iterations/sec.  The adversary dual dominates the solve; ``bisect`` runs
    the host's ~50 sequential fixed-point evaluations per outer iteration,
    ``parallel`` the vmapped grid search (beta_rounds=3 walls)."""
    import jax.numpy as jnp

    import trajopt_jax
    from trajopt_jax.parallel.rgps import make_rgps_solver

    env = trajopt_jax.make("LQR-TO-v1")
    solve = make_rgps_solver(
        env, variant="lr", nb_steps=T, nb_iter=nb_iter,
        init_action_sigma=10.0, policy_kl_bound=0.25,
        param_nominal_kl_bound=50.0, nominal_variance=1e-8,
        beta_search=beta_search, alpha_search=beta_search,
    )
    mu0, sigma0 = env.init()
    mu0 = jnp.asarray(np.array(mu0), jnp.float32)
    sigma0 = jnp.asarray(np.array(sigma0), jnp.float32)
    sec = _seconds(f"rgps_solve_iters_per_s_{beta_search}",
                   lambda m, s: solve(m, s)[1], (mu0, sigma0),
                   lambda sc: nb_iter / sc)
    return nb_iter / sec


def _cpu_denominators(T_gps):
    """Measured single-thread C++ denominators for every BASELINE config
    (native/baseline.cpp; parity-pinned against the JAX kernels in
    tests/test_utils.py and tests/test_bspilqr.py).  Each is a KERNEL-ONLY
    lower bound on the reference's per-iteration cost — its real iterations
    add per-t autograd linearization and Python loops on top — so every
    derived vs-CPU ratio is conservative.  Returns a dict of rates.

    Configs (BASELINE.md protocol):
      riccati:  the exact backward recursion at T=100 on the homogeneous-
                coordinate dims the kernel runs (dx=3, du=1) -> ts/s.
      elqr:     2 value recursions (forward LQR + backward LQR) per iteration
                at cartpole dims (dx=4, du=1, T=100) -> iters/s.
      bsp:      nb_iter=10 belief-value backward passes (b=2, a=2, vec-channel
                4, T=25) per MPC step -> steps/s.
      gps:      the full dual-evaluation chain at dx=4, du=2 -> ts/s.
      rgps:     one adversary fixed-point trip (parameter backward + cubature
                forward + KL/damping) at dx=4, du=2, T=100 -> ts/s.
    """
    from trajopt_jax.utils.native import (
        bench_backward_native,
        bench_bsp_backward_native,
        bench_gps_dual_chain_native,
        bench_rgps_fixed_point_native,
    )

    rng = np.random.default_rng(1)
    den = {}

    # riccati: T=100, homogeneous dims (dx+1=3, du=1)
    p = _problem(100, 3, 1, 0)
    reps = 200
    t = min(bench_backward_native(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"],
        0.0, reps=reps) for _ in range(3))
    den["riccati_cpu_tps"] = 100 * reps / t

    # elqr: 2 value recursions per iteration at cartpole dims
    p = _problem(100, 4, 1, 0)
    t = min(bench_backward_native(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"],
        0.0, reps=reps) for _ in range(3))
    den["elqr_cpu_iters_per_s"] = reps / (2.0 * t)

    # bsp: (a) the full per-control-step chain (FD expansion + λ backward +
    # 11-α rollouts + accept, ×10, + EKF update) — the honest apples-to-apples
    # denominator for the MPC steps/s row; (b) the 10-backward-passes-only
    # figure kept as the über-conservative variant (a strict lower bound on
    # the reference's per-step cost)
    from trajopt_jax.utils.native import bench_bsp_mpc_step_native

    T_b = 25
    reps_m = 400
    t = min(bench_bsp_mpc_step_native(T=T_b, nb_iter=10, reps=reps_m)
            for _ in range(3))
    den["bsp_cpu_steps_per_s"] = reps_m / t
    bcost, bdyn = _belief_problem(T_b, rng)
    reps_b = 2000
    t = min(bench_bsp_backward_native(bcost, bdyn, 0.1, 1, reps=reps_b)
            for _ in range(3))
    den["bsp_cpu_steps_per_s_backward_only"] = reps_b / (10.0 * t)
    den["bsp_cpu_tps"] = T_b * reps_b / t

    # gps: full dual-evaluation chain, dims 4/2
    dx, du = 4, 2
    p = _problem(T_gps, dx, du, 0)
    K = 0.1 * rng.standard_normal((T_gps, du, dx))
    kffs = 0.1 * rng.standard_normal((T_gps, du))
    Sctl = np.broadcast_to(np.eye(du), (T_gps, du, du)).copy()
    Sdyn = np.broadcast_to(1e-4 * np.eye(dx), (T_gps, dx, dx)).copy()
    alpha = np.full(T_gps, 10.0)
    mu0 = np.zeros(dx)
    sig0 = 0.1 * np.eye(dx)
    reps_g = max(2, 2000 // T_gps)
    t = min(bench_gps_dual_chain_native(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["c0"],
        p["A"], p["B"], p["c"], Sdyn, K, kffs, Sctl, alpha, mu0, sig0,
        reps=reps_g) for _ in range(3))
    den["gps_cpu_tps"] = T_gps * reps_g / t

    # rgps: one adversary fixed-point trip at T=100, dims 4/2
    T_r = 100
    p = _problem(T_r, dx, du, 0)
    p1 = dx + du + 1
    pdim = dx * p1
    theta = np.concatenate(
        [np.swapaxes(p["A"], -1, -2).reshape(T_r, dx * dx),
         np.swapaxes(p["B"], -1, -2).reshape(T_r, du * dx), p["c"]], axis=-1,
    )
    lam_nom = 1e4  # (1e-4 I)^-1
    scale = 100.0
    agCpp = np.broadcast_to(0.5 * scale * lam_nom * np.eye(pdim),
                            (T_r, pdim, pdim)).copy()
    agcp = -scale * lam_nom * theta
    K = 0.05 * rng.standard_normal((T_r, du, dx))
    kffs = 0.05 * rng.standard_normal((T_r, du))
    Sctl = np.broadcast_to(np.eye(du), (T_r, du, du)).copy()
    Sdyn = np.broadcast_to(1e-4 * np.eye(dx), (T_r, dx, dx)).copy()
    qmu = np.zeros((T_r + 1, dx))
    qsig = np.broadcast_to(0.05 * np.eye(dx), (T_r + 1, dx, dx)).copy()
    reps_r = 5
    t = min(bench_rgps_fixed_point_native(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["c0"],
        K, kffs, Sctl, Sdyn, agCpp, agcp, 200.0, qmu, qsig,
        np.zeros(dx), 0.01 * np.eye(dx), reps=reps_r) for _ in range(3))
    den["rgps_cpu_tps"] = T_r * reps_r / t

    return den


def _try_bench(extras, failed_rows, name, fn):
    """Run one bench row; success lands in ``extras``, failure in
    ``failed_rows`` — a flagship row silently vanishing from the emitted JSON
    with rc=0 (round 4's bsp_lightdark_mpc_steps_per_s) must be impossible:
    the failure travels in the JSON line itself, not just stderr.  Covered by
    tests/test_utils.py::test_bench_failed_rows_land_in_json."""
    try:
        extras[name] = round(fn(), 1)
    except Exception as e:
        failed_rows[name] = f"{type(e).__name__}: {e}"[:300]
        print(f"bench {name} failed: {e!r}", file=sys.stderr)


def main():
    import jax

    from trajopt_jax.utils.compile_cache import enable_compile_cache
    from trajopt_jax.utils.native import bench_backward_native

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {dev.platform!r} devices; "
                         "the benchmark measures the GPU only")
    enable_compile_cache()
    T, dx, du = 1000, 4, 2

    extras = {}
    failed_rows = {}

    def try_bench(name, fn):
        _try_bench(extras, failed_rows, name, fn)

    # headline: full iLQR iterations/sec at horizon 1000
    iters_per_s, sec_per_batch_iter, engine_tag, hl_T, hl_N = bench_ilqr_iters()

    try_bench("ilqr_backward_tps@16384",
              lambda: bench_backward_packed(T, dx, du, 16384))
    try_bench("riccati_T100_tps@4096", bench_riccati)
    try_bench("elqr_cartpole_iters_per_s@64", bench_elqr)
    try_bench("bsp_lightdark_mpc_steps_per_s", bench_bsp)
    try_bench("bsp_backward_tps@4096", bench_bsp_backward_batched)
    try_bench("gps_dual_eval_tps@4096", bench_gps_dual)
    try_bench("rgps_fixed_point_tps@8", bench_rgps_fixed_point)
    try_bench("rgps_fixed_point_tps@64", lambda: bench_rgps_fixed_point(batch=64))
    try_bench("rgps_solve_iters_per_s_bisect", bench_rgps_solve)
    try_bench("rgps_solve_iters_per_s_parallel",
              lambda: bench_rgps_solve(beta_search="parallel"))

    # per-config CPU denominators (native/baseline.cpp) -> conservative vs-CPU
    # ratios for every BASELINE config
    try:
        den = _cpu_denominators(T_gps=1000)
        ratios = [
            ("riccati_T100_tps@4096", "riccati_cpu_tps", "riccati_vs_cpu"),
            ("elqr_cartpole_iters_per_s@64", "elqr_cpu_iters_per_s",
             "elqr_vs_cpu"),
            ("bsp_lightdark_mpc_steps_per_s", "bsp_cpu_steps_per_s",
             "bsp_mpc_vs_cpu"),
            ("bsp_lightdark_mpc_steps_per_s",
             "bsp_cpu_steps_per_s_backward_only",
             "bsp_mpc_vs_cpu_backward_only"),
            ("bsp_backward_tps@4096", "bsp_cpu_tps", "bsp_vs_cpu"),
            ("gps_dual_eval_tps@4096", "gps_cpu_tps", "gps_vs_cpu"),
            ("rgps_fixed_point_tps@8", "rgps_cpu_tps", "rgps_vs_cpu"),
            ("rgps_fixed_point_tps@64", "rgps_cpu_tps", "rgps_vs_cpu@64"),
        ]
        for dev_key, cpu_key, ratio_key in ratios:
            if dev_key in extras:
                extras[ratio_key] = round(extras[dev_key] / den[cpu_key], 2)
    except Exception as e:  # pragma: no cover - defensive: report, keep going
        failed_rows["cpu_denominators"] = f"{type(e).__name__}: {e}"[:300]
        print(f"cpu denominators failed: {e!r}", file=sys.stderr)

    # CPU C++ baseline: the backward pass alone at T=1000 (a strict LOWER bound on
    # the reference's per-iteration cost — its iteration adds per-t autograd
    # linearization and Python rollout loops).  Best of 3 blocks: a contended
    # run would inflate vs_baseline.
    single = _problem(hl_T, dx, du, 0)
    reps = 20
    t_cpu = min(
        bench_backward_native(
            single["Cxx"], single["cx"], single["Cuu"], single["cu"],
            single["Cxu"], single["A"], single["B"], 0.0, reps=reps,
        )
        for _ in range(3)
    )
    cpu_iters_upper_bound = reps / t_cpu  # iterations/s if an iteration were ONLY the backward pass

    result = {
        "metric": f"ilqr_iters_per_sec_T{hl_T}",
        "value": round(iters_per_s, 1),
        "unit": (
            f"instance-iterations/s ({dev.platform} {dev.device_kind}, cartpole "
            f"dx=4, T={hl_T}, batch {hl_N}, {engine_tag}, full linearize+backward+"
            f"linesearch iteration = {sec_per_batch_iter * 1e3:.3f} ms/batch-iter; "
            f"host clock around block_until_ready, median of {REPEATS}; "
            f"vs_baseline is conservative: CPU denominator is the C++ backward "
            f"pass alone, {cpu_iters_upper_bound:.1f} it/s upper bound)"
        ),
        "vs_baseline": round(iters_per_s / cpu_iters_upper_bound, 2),
        "extras": extras,
    }
    for name, (lo, hi) in SPREADS.items():
        extras[f"{name}_spread"] = [lo, hi]
    if failed_rows:
        result["failed_rows"] = failed_rows
    print(json.dumps(result))


if __name__ == "__main__":
    main()
