"""Smoke run of the solvers on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: every single-device phase
    python chip_smoke.py --multichip  # four GPUs: the sharded phase only

Single-device phases:

* device     — platform check, card name and power limit, JAX version, matmul
               precision (must read ``highest``);
* reference  — the Riccati / iLQR / MBGPS host classes on the GPU in f32
               against the same calls on the CPU in f64;
* main path  — ``make_ilqr_solver_batched(Cartpole-TO-v0, T=1000, nb_iter=10)``
               on 2048 instances with the scan engines and with the Pallas
               kernels: the engines compared per instance, 8 instances against
               the CPU f64 per-instance solver, and each engine's wall time per
               batch-iteration;
* kernels    — each Pallas kernel alone at real widths against its plain
               reference (f64 on the CPU, a sample of instances), and timed
               against the scan version XLA compiles;
* families   — eLQR, the light-dark BSP MPC episode, RGPS and the IOC gradient
               step on their scan paths, against the CPU in f64.

``--multichip`` runs the dp-sharded and time-sharded paths over a 4-GPU mesh
and compares each with the same call unsharded on one GPU.

Every comparison prints its maximum relative error beside its tolerance.  A
failed phase or comparison ends the run with a non-zero exit and no result;
the last line of a passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import trajopt_jax
from trajopt_jax.utils.compile_cache import enable_compile_cache
from trajopt_jax.utils.profiling import seconds_per_call


class SmokeFailure(Exception):
    """A comparison out of tolerance or a result that is not finite."""


def rel_err(got, want) -> float:
    """max |got − want| / max |want| (inf when ``got`` is not finite)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max rel err {err:.3e} (tol {tol:.0e})", flush=True)
    if not err <= tol:
        raise SmokeFailure(f"{name}: {err:.3e} > {tol:.0e}")


def check_true(name: str, ok: bool) -> None:
    print(f"  {name}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise SmokeFailure(name)


def to_cpu64(tree):
    cpu = jax.devices("cpu")[0]
    return jax.tree.map(
        lambda x: jax.device_put(np.asarray(x, np.float64), cpu), tree
    )


@contextlib.contextmanager
def cpu_f64():
    """Run the enclosed reference computation on the CPU in float64."""
    with jax.default_device(jax.devices("cpu")[0]), jax.enable_x64(True):
        yield


def f32(x):
    return jnp.asarray(np.asarray(x), jnp.float32)


# --------------------------------------------------------------------------------------
# device
# --------------------------------------------------------------------------------------


def phase_device(count: int) -> None:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {devs[0].platform!r} devices")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX reports {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    prec = jax.config.jax_default_matmul_precision
    print(f"jax {jax.__version__}, {devs[0].device_kind} x{len(devs)}, "
          f"jax_default_matmul_precision={prec}, "
          f"compile cache {enable_compile_cache()}", flush=True)
    check_true("matmul precision is 'highest'", prec == "highest")


# --------------------------------------------------------------------------------------
# reference-semantics host classes
# --------------------------------------------------------------------------------------


def phase_reference(T: int = 60, ilqr_iters: int = 25, gps_iters: int = 5) -> None:
    """Riccati, iLQR and MBGPS host classes, GPU f32 vs CPU f64."""
    from trajopt_jax.solvers import MBGPS, Riccati, iLQR

    print("[reference] host classes, GPU f32 vs CPU f64", flush=True)
    lqr = trajopt_jax.make("LQR-TO-v0")
    pend = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)

    def riccati():
        return float(Riccati(lqr, nb_steps=T, init_state=lqr.init()).run())

    def ilqr():
        s = iLQR(pend, nb_steps=T, init_state=np.array(pend.x0),
                 action_penalty=1e-5)
        tr = s.run(nb_iter=ilqr_iters)
        return float(tr[-1]), float(s.xref[-1, 0])

    def mbgps():
        s = MBGPS(pend, nb_steps=T, init_state=pend.init(),
                  init_action_sigma=5.0, kl_bound=10.0, action_penalty=1.0)
        return float(s.run(nb_iter=gps_iters)[-1])

    c_gpu, (i_gpu, th_gpu), g_gpu = riccati(), ilqr(), mbgps()
    with cpu_f64():
        c_cpu, (i_cpu, th_cpu), g_cpu = riccati(), ilqr(), mbgps()
    print(f"  Riccati LQR-TO-v0 T={T}: gpu {c_gpu:.6f} cpu {c_cpu:.6f}")
    print(f"  iLQR Pendulum-TO-v0 T={T}: gpu {i_gpu:.6f} (final theta "
          f"{th_gpu:.2e}) cpu {i_cpu:.6f} (final theta {th_cpu:.2e})")
    print(f"  MBGPS Pendulum-TO-v0 T={T}, {gps_iters} iterations: gpu {g_gpu:.6f} "
          f"cpu {g_cpu:.6f}")
    # one exact backward sweep: f32 rounding only
    check("Riccati cost", rel_err(c_gpu, c_cpu), 1e-4)
    # 25 iterations of accept/reject in f32 land on the same optimum; the
    # tolerance covers the f32 converged cost, not a different local solution
    check("iLQR cost", rel_err(i_gpu, i_cpu), 1e-3)
    check_true("iLQR swings up (|final theta| < 0.05)", abs(th_gpu) < 0.05)
    # the KL dual is bisected in f32: the accepted step sizes differ slightly
    check("MBGPS cost", rel_err(g_gpu, g_cpu), 1e-3)


# --------------------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------------------

# scan/scan first (the reference for the others); the two mixed pairs time
# each kernel alone inside the full iteration
MAIN_ENGINES = (("scan", "scan"), ("pallas", "scan"), ("scan", "pallas"),
                ("pallas", "pallas"))


def main_path_inputs(N: int):
    env = trajopt_jax.make("Cartpole-TO-v0")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    x0 = jnp.asarray(np.array(env.x0), jnp.float32)
    x0s = jnp.tile(x0, (N, 1))
    x0s = x0s.at[:, 0].add(jax.random.uniform(k1, (N,), jnp.float32, -0.5, 0.5))
    x0s = x0s.at[:, 1].add(jax.random.uniform(k2, (N,), jnp.float32, -0.2, 0.2))
    return env, x0s


def phase_main_path(N: int = 2048, T: int = 1000, nb_iter: int = 10,
                    n_cpu: int = 8, repeats: int = 5, interpret: bool = False):
    """Batched iLQR solve, both engine pairs; returns the kernel engine's final
    state (realistic operands for the rollout-kernel phase)."""
    from trajopt_jax.parallel.mpc import make_ilqr_solver, make_ilqr_solver_batched

    print(f"[main path] make_ilqr_solver_batched(Cartpole-TO-v0, T={T}, "
          f"nb_iter={nb_iter}), batch {N}", flush=True)
    env, x0s = main_path_inputs(N)
    states, traces = {}, {}
    for backward, rollout in MAIN_ENGINES:
        solve = make_ilqr_solver_batched(
            env, T, nb_iter=nb_iter, backward=backward, rollout=rollout,
            interpret=interpret,
        )
        f = solve if interpret else jax.jit(solve)
        start = time.perf_counter()
        state, trace = jax.block_until_ready(f(x0s))
        first = time.perf_counter() - start
        med, (lo, hi) = seconds_per_call(f, (x0s,), repeats)
        tag = f"backward={backward},rollout={rollout}"
        print(f"  {tag}: first call (compile + run) {first:.2f} s; "
              f"{med / nb_iter * 1e3:.3f} ms per batch-iteration (median of "
              f"{repeats}; min {lo / nb_iter * 1e3:.3f}, max {hi / nb_iter * 1e3:.3f}); "
              f"{N * nb_iter / med:.1f} instance-iterations/s; "
              f"mean return {float(jnp.mean(state.last_return)):.6f}", flush=True)
        check_true(f"{tag} returns finite",
                   bool(jnp.all(jnp.isfinite(trace))))
        states[tag], traces[tag] = state, np.asarray(trace, np.float64)

    # The iterates are sensitive to roundoff: an accept/reject decision taken
    # at the margin flips and moves an instance onto another iterate.  On the
    # CPU the scan engine in f32 and in f64 agrees to 3e-7 per instance after
    # the first iteration and differs by a median 2% after ten.  So instances
    # are compared on the first iteration, and the batch after all of them.
    (tag_a, ta), *others = traces.items()
    for tag_b, tb in others:
        per = np.abs(ta - tb) / np.abs(ta)
        print(f"  {tag_b} vs {tag_a} per instance, per iteration: median rel "
              "diff " + " ".join(f"{m:.1e}" for m in np.median(per, axis=1)))
        check(f"{tag_b} vs {tag_a} per instance, first iteration",
              per[0].max(), 1e-4)
        check(f"{tag_b} vs {tag_a} batch-mean return after {nb_iter} "
              "iterations", rel_err(tb[-1].mean(), ta[-1].mean()), 1e-2)

    with cpu_f64():
        ref = np.asarray(jax.jit(jax.vmap(make_ilqr_solver(env, T, nb_iter=nb_iter)))(
            to_cpu64(x0s[:n_cpu]))[1])           # (n_cpu, nb_iter)
    for tag, tr in traces.items():
        final = np.abs(tr[-1, :n_cpu] - ref[:, -1]) / np.abs(ref[:, -1])
        print(f"  {tag} vs CPU f64 after {nb_iter} iterations, per instance: "
              + " ".join(f"{d:.1e}" for d in final))
        check(f"{tag} vs CPU f64 per-instance solver, first iteration "
              f"({n_cpu} instances)", rel_err(tr[0, :n_cpu], ref[:, 0]), 1e-4)
    return env, states["backward=pallas,rollout=pallas"]


# --------------------------------------------------------------------------------------
# kernels at real widths
# --------------------------------------------------------------------------------------


def random_lqr(key, N, T, dx, du, affine=False):
    """Stable random batched LQR stacks (f32, generated on the device)."""
    from trajopt_jax.core.types import QuadraticCost

    ks = jax.random.split(key, 9)

    def spd(k, d, n):
        M = jax.random.normal(k, (N, n, d, d), jnp.float32)
        return jnp.einsum("bnij,bnkj->bnik", M, M) / d + jnp.eye(d, dtype=jnp.float32)

    cost = QuadraticCost(
        Cxx=spd(ks[0], dx, T + 1),
        cx=jax.random.normal(ks[1], (N, T + 1, dx), jnp.float32),
        Cuu=spd(ks[2], du, T + 1),
        cu=jax.random.normal(ks[3], (N, T + 1, du), jnp.float32),
        Cxu=0.1 * jax.random.normal(ks[4], (N, T + 1, dx, du), jnp.float32),
        c0=jnp.zeros((N, T + 1), jnp.float32),
    )
    A = 0.8 * jnp.eye(dx, dtype=jnp.float32) + 0.05 * jax.random.normal(
        ks[5], (N, T, dx, dx), jnp.float32)
    B = 0.1 * jax.random.normal(ks[6], (N, T, dx, du), jnp.float32)
    lam = jax.random.uniform(ks[7], (N,), jnp.float32, 0.0, 1.0)
    c = 0.01 * jax.random.normal(ks[8], (N, T, dx), jnp.float32)
    return (cost, A, B, lam, c) if affine else (cost, A, B, lam)


def phase_kernels(main_env, main_state, Nb=16384, Tb=1000, Nr=4096, Tr=100,
                  n_sample=16, repeats=5, interpret=False):
    from trajopt_jax.core.pallas_lqr import (
        pallas_ilqr_backward,
        pallas_riccati_backward,
    )
    from trajopt_jax.core.pallas_rollout import (
        pack_rollout,
        pallas_rollout_returns,
        pallas_rollout_selected,
    )
    from trajopt_jax.core.scan_lqr import ilqr_backward, riccati_backward
    from trajopt_jax.core.types import LinearDynamics, LinearPolicy
    from trajopt_jax.solvers.common import (
        DEFAULT_ALPHAS,
        make_weighting,
        rollout_tracking,
    )

    jit = (lambda f: f) if interpret else jax.jit

    def timed(name, kernel_f, scan_f, args):
        tk, _ = seconds_per_call(kernel_f, args, repeats)
        ts, _ = seconds_per_call(scan_f, args, repeats)
        print(f"  {name}: kernel {tk * 1e3:.3f} ms, scan {ts * 1e3:.3f} ms "
              f"(median of {repeats}; scan/kernel {ts / tk:.2f}x)", flush=True)

    # ---- iLQR backward -------------------------------------------------------------
    dx, du = 4, 2
    print(f"[kernels] iLQR backward, batch {Nb}, T={Tb}, dx={dx}, du={du}",
          flush=True)
    cost, A, B, lam = random_lqr(jax.random.PRNGKey(1), Nb, Tb, dx, du)
    bad_ids = np.array([3, Nb // 2, Nb - 1])
    # indefinite Quu at one interior step with λ = 0: the divergence flag
    cost = cost._replace(Cuu=cost.Cuu.at[bad_ids, Tb // 3].set(
        -10.0 * jnp.eye(du, dtype=jnp.float32)))
    lam = lam.at[bad_ids].set(0.0)
    sample = np.concatenate([np.arange(n_sample), bad_ids])

    kern = jit(lambda c, a, b, l: pallas_ilqr_backward(c, a, b, l, 1,
                                                       interpret=interpret))

    def scan_one(c, a, b, l):
        pol, _, _, dV, div = ilqr_backward(c, a, b, l, 1)
        return pol.K, pol.kff, dV, div

    pol, dV, div = jax.block_until_ready(kern(cost, A, B, lam))
    take = lambda t: jax.tree.map(lambda x: x[sample], t)
    with cpu_f64():
        K_r, kff_r, dV_r, div_r = jax.jit(jax.vmap(scan_one))(
            *to_cpu64(take((cost, A, B, lam))))
    good = ~np.asarray(div_r)
    check_true("divergence flags match the reference",
               np.array_equal(np.asarray(div)[sample], np.asarray(div_r))
               and not good[-len(bad_ids):].any())
    # f32 over a contracting 1000-step recursion: errors stay at the f32 level
    check("backward K", rel_err(pol.K[sample][good], K_r[good]), 1e-4)
    check("backward kff", rel_err(pol.kff[sample][good], kff_r[good]), 1e-4)
    check("backward dV", rel_err(dV[sample][good], dV_r[good]), 1e-4)
    if not interpret:
        timed("backward", kern, jax.jit(jax.vmap(scan_one)), (cost, A, B, lam))
    del cost, A, B, lam, pol, dV, div

    # ---- Riccati reduction ---------------------------------------------------------
    print(f"[kernels] Riccati reduction, batch {Nr}, T={Tr}, dx={dx}, du={du}",
          flush=True)
    cost, A, B, _, c = random_lqr(jax.random.PRNGKey(2), Nr, Tr, dx, du,
                                  affine=True)
    kern = jit(lambda c_, a, b, d: pallas_riccati_backward(
        c_, a, b, d, interpret=interpret))

    def ric_one(c_, a, b, d):
        ctl, _ = riccati_backward(c_, LinearDynamics(A=a, B=b, c=d))
        return ctl.K, ctl.kff

    pol, div = jax.block_until_ready(kern(cost, A, B, c))
    sample = np.arange(n_sample)
    with cpu_f64():
        K_r, kff_r = jax.jit(jax.vmap(ric_one))(
            *to_cpu64(jax.tree.map(lambda x: x[sample], (cost, A, B, c))))
    check_true("Riccati: no divergence", not bool(jnp.any(div)))
    check("Riccati K", rel_err(pol.K[sample], K_r), 1e-4)
    check("Riccati kff", rel_err(pol.kff[sample], kff_r), 1e-4)
    if not interpret:
        timed("Riccati", kern, jax.jit(jax.vmap(ric_one)), (cost, A, B, c))
    del cost, A, B, c, pol, div

    # ---- rollout / line search -----------------------------------------------------
    env, st = main_env, main_state
    N, T = st.K.shape[0], st.K.shape[1]
    alphas = tuple(float(a) for a in DEFAULT_ALPHAS)
    print(f"[kernels] rollout / line search, {len(alphas)} alphas x {N} x T={T} "
          "(operands: the main-path kernel solve's final iterate)", flush=True)
    w = make_weighting(T, None).astype(jnp.float32)
    pick = jnp.arange(N) % len(alphas)

    def kernel_ls(K, kff, xref, uref):
        pk = pack_rollout(K, kff, xref, uref)
        ret, ok = pallas_rollout_returns(env, pk, w, alphas, interpret=interpret)
        xs, us, _ = pallas_rollout_selected(
            env, pk, w, jnp.asarray(alphas, jnp.float32)[pick], interpret=interpret)
        return ret[:N], ok[:N], xs, us

    def scan_ls(K, kff, xref, uref):
        def one(K1, kff1, xr, ur):
            ctl = LinearPolicy(K=K1, kff=kff1)
            return jax.vmap(lambda a: rollout_tracking(
                env, ctl, a, xr[0], xr, ur, w))(jnp.asarray(alphas, jnp.float32))
        xs, us, cs = jax.vmap(one)(K, kff, xref, uref)
        n = K.shape[0]   # the CPU reference runs on the first n instances
        rows = jnp.arange(n)
        return (jnp.sum(cs, -1), jnp.all(xs < 1e8, axis=(2, 3)),
                xs[rows, pick[:n]], us[rows, pick[:n]])

    args = (st.K, st.kff, st.xref, st.uref)
    kl = jit(kernel_ls)
    got = jax.tree.map(lambda x: np.asarray(x)[:n_sample], kl(*args))
    sub = jax.tree.map(lambda x: x[:n_sample], args)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref32 = jax.jit(scan_ls)(*jax.device_put(sub, cpu))
    with cpu_f64():
        w = make_weighting(T, None)
        ref64 = jax.jit(scan_ls)(*to_cpu64(sub))
    check_true("rollout finite flags match",
               np.array_equal(got[1], np.asarray(ref64[1])))
    # The final iterate of the unconverged swing-up is a chaotic trajectory:
    # 1000 RK4 steps amplify f32 roundoff, so the plain scan in f32 itself
    # differs from f64 (printed below).  The kernel must be as accurate as
    # that plain f32 computation, within a factor 10 (floor 1e-4).
    for i, what in ((0, "returns (all alphas)"), (2, "states (selected alpha)"),
                    (3, "actions (selected alpha)")):
        plain = rel_err(ref32[i], ref64[i])
        print(f"  plain f32 scan {what} vs f64: {plain:.3e}")
        check(f"rollout kernel {what} vs f64", rel_err(got[i], ref64[i]),
              max(1e-4, 10 * plain))
    if not interpret:
        w = make_weighting(T, None).astype(jnp.float32)
        timed("line search (phase A + phase B)", kl, jax.jit(scan_ls), args)


# --------------------------------------------------------------------------------------
# other families on their scan paths
# --------------------------------------------------------------------------------------


def phase_families(elqr_N=64, elqr_T=100, bsp_T=25, bsp_steps=50, rgps_T=20,
                   ioc_N=8, ioc_T=50) -> None:
    from trajopt_jax.parallel.bsp import make_bsp_mpc_runner
    from trajopt_jax.parallel.diffmpc import make_ilqr_solver_diff
    from trajopt_jax.parallel.elqr import make_elqr_solver_batched
    from trajopt_jax.parallel.rgps import make_rgps_solver

    def both(name, build, args, ref_f64=True):
        """Run ``build()(*args)`` on the GPU in f32 and on the CPU in f64 (in
        f32 with ``ref_f64=False``)."""
        start = time.perf_counter()
        gpu = jax.block_until_ready(jax.jit(build())(*jax.tree.map(f32, args)))
        print(f"[families] {name}: GPU {time.perf_counter() - start:.2f} s "
              "(compile + run)", flush=True)
        if ref_f64:
            with cpu_f64():
                cpu = jax.jit(build())(*to_cpu64(args))
        else:
            cpu_dev = jax.devices("cpu")[0]
            with jax.default_device(cpu_dev):
                cpu = jax.jit(build())(*jax.device_put(
                    jax.tree.map(f32, args), cpu_dev))
        return jax.tree.map(np.asarray, (gpu, cpu))

    # eLQR, batched (scan engine)
    cp = trajopt_jax.make("Cartpole-TO-v0")
    x0s = np.tile(np.array(cp.x0), (elqr_N, 1))
    x0s[:, 1] += np.linspace(-0.1, 0.1, elqr_N)

    def build_elqr():
        solve = make_elqr_solver_batched(cp, elqr_T, nb_iter=10)
        return lambda x0: solve(
            jax.random.split(jax.random.PRNGKey(3), elqr_N), x0)

    (_, _, _, tr_g), (_, _, _, tr_c) = both(
        f"batched eLQR cartpole, batch {elqr_N}, T={elqr_T}", build_elqr, (x0s,))
    check_true("eLQR finite", bool(np.all(np.isfinite(tr_g))))
    # 10 sweeps from f32 random feedforwards: converged costs agree to f32 level
    check("eLQR final returns", rel_err(tr_g[:, -1], tr_c[:, -1]), 1e-3)

    # light-dark BSP MPC episode (EKF in the loop, scan engine)
    ld = trajopt_jax.make("LightDark-TO-v0")
    # The episode samples the true system's and the observations' noise from
    # the key; f32 and f64 draw different numbers from the same key, so this
    # reference runs on the CPU in f32 with the same draws.
    (xs_g, _, _, _, cs_g), (xs_c, _, _, _, cs_c) = both(
        f"light-dark BSP MPC, T={bsp_T}, {bsp_steps} steps, 10 iterations",
        lambda: (lambda x0: make_bsp_mpc_runner(ld, bsp_T, bsp_steps, nb_iter=10)(
            jax.random.PRNGKey(4), x0)), (np.array(ld.reset_state()),),
        ref_f64=False)
    check_true("BSP finite", bool(np.all(np.isfinite(cs_g))))
    # f32 on both sides; the EKF-in-the-loop replans amplify last-bit
    # differences between the GPU's and the CPU's kernels over 50 steps
    check("BSP episode cost", rel_err(np.sum(cs_g), np.sum(cs_c)), 1e-3)

    # RGPS lr (cubature fixed point, cuSOLVER/eigh-free scan path)
    lqr_adv = trajopt_jax.make("LQR-TO-v1")
    mu0, sig0 = lqr_adv.init()
    (_, tr_g), (_, tr_c) = both(
        f"RGPS lr LQR-TO-v1, T={rgps_T}",
        lambda: make_rgps_solver(
            lqr_adv, variant="lr", nb_steps=rgps_T, nb_iter=3,
            init_action_sigma=10.0, policy_kl_bound=0.25,
            param_nominal_kl_bound=50.0, nominal_variance=1e-8),
        (np.array(mu0), np.array(sig0)))
    check_true("RGPS finite", bool(np.all(np.isfinite(tr_g))))
    # the β and α duals are bisected in f32; the accepted costs agree to 1e-3
    check("RGPS trace", rel_err(tr_g, tr_c), 1e-3)

    # IOC gradient step through the differentiable solve
    pend = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    x0b = np.tile(np.array(pend.x0), (ioc_N, 1)) + np.linspace(
        0.0, 0.2, ioc_N)[:, None]
    u_star = np.zeros((ioc_N, ioc_T, 1))

    def build_ioc():
        dsolve = make_ilqr_solver_diff(
            pend, ioc_T, nb_iter=3, lm_steps=6,
            param_apply=lambda e, p: e.replace(gw=p))

        def loss(gw, x0):
            st, _ = dsolve(x0, gw)
            return jnp.mean((st.uref - u_star) ** 2)

        return jax.value_and_grad(loss)

    (l_g, g_g), (l_c, g_c) = both(
        f"IOC gradient step, batch {ioc_N}, T={ioc_T}", build_ioc,
        (np.array([1.0, 0.1]), x0b))
    # gradients through 3 iterations of f32 linearizations and rollouts
    check("IOC loss", rel_err(l_g, l_c), 1e-3)
    check("IOC gradient", rel_err(g_g, g_c), 1e-2)


# --------------------------------------------------------------------------------------
# four devices
# --------------------------------------------------------------------------------------


def phase_multichip(devices, main_backward: str = "pallas",
                    interpret: bool = False) -> None:
    """Sharded paths over a 4-device mesh, each against the same call unsharded
    on one device."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from trajopt_jax.parallel.bsp import make_bsp_solver, make_bsp_solver_batched
    from trajopt_jax.parallel.elqr import make_elqr_solver_batched
    from trajopt_jax.parallel.gps import make_mbgps_solver, run_gps_mpc_batch
    from trajopt_jax.parallel.mpc import make_ilqr_solver, run_mpc_batch
    from trajopt_jax.parallel.rgps import run_rgps_batch
    from trajopt_jax.solvers import Riccati

    n = len(devices)
    dp = Mesh(np.array(devices), ("dp",))
    tm = Mesh(np.array(devices), ("time",))
    put = lambda x: jax.device_put(x, NamedSharding(dp, P("dp")))

    def spread(name, x):
        got = len(x.sharding.device_set)
        check_true(f"{name} spread over {n} devices (found {got})", got == n)

    def compare(name, sharded, single, tol):
        spread(name, sharded)
        check(f"{name} sharded vs one device", rel_err(sharded, single), tol)

    print(f"[multichip] dp axis over {n} devices", flush=True)
    pend = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    kw = dict(nb_episodes=16 * n, horizon=40, nb_steps=5, nb_iter=5, batched=True,
              backward=main_backward, interpret=interpret)
    key = jax.random.PRNGKey(0)
    one = run_mpc_batch(pend, key, **kw)
    shd = run_mpc_batch(pend, key, mesh=dp, **kw)
    # every shard runs the identical per-instance program: equal up to the
    # last bits of XLA's batched-op choices
    compare(f"run_mpc_batch (backward={main_backward})", shd["x"], one["x"], 1e-5)

    cp = trajopt_jax.make("Cartpole-TO-v0")
    keys = jax.random.split(jax.random.PRNGKey(1), 8 * n)
    x0s = jnp.tile(jnp.asarray(np.array(cp.x0), jnp.float32), (8 * n, 1))
    x0s = x0s.at[:, 1].add(jnp.linspace(-0.1, 0.1, 8 * n, dtype=jnp.float32))
    one = jax.jit(make_elqr_solver_batched(cp, 50, nb_iter=5))(keys, x0s)[3]
    shd = jax.jit(make_elqr_solver_batched(cp, 50, nb_iter=5, mesh=dp))(
        put(keys), put(x0s))[3]
    compare("batched eLQR", shd, one, 1e-5)

    ld = trajopt_jax.make("LightDark-TO-v0")
    mu0, sig0 = ld.init()
    mus = jnp.tile(jnp.asarray(np.array(mu0), jnp.float32), (4 * n, 1))
    mus = mus + jnp.linspace(0.0, 0.5, 4 * n, dtype=jnp.float32)[:, None]
    sigs = jnp.tile(jnp.asarray(np.array(sig0), jnp.float32), (4 * n, 1, 1))
    one = jax.jit(make_bsp_solver_batched(ld, 25, nb_iter=5))(mus, sigs)[0]
    shd = jax.jit(make_bsp_solver_batched(ld, 25, nb_iter=5, mesh=dp))(
        put(mus), put(sigs))[0]
    compare("batched BSP", shd.last_return, one.last_return, 1e-5)

    gkw = dict(nb_episodes=2 * n, horizon=20, nb_steps=3, nb_iter=2, kl_bound=2.0,
               batched=True)
    one = run_gps_mpc_batch(pend, jax.random.PRNGKey(2), **gkw)
    shd = run_gps_mpc_batch(pend, jax.random.PRNGKey(2), mesh=dp, **gkw)
    compare("batched GPS MPC", shd["x"], one["x"], 1e-5)

    lqr_adv = trajopt_jax.make("LQR-TO-v1", sigma_scale=1e-4)
    rkw = dict(nb_problems=2 * n, nb_steps=20, variant="lr", nb_iter=2,
               init_action_sigma=10.0, policy_kl_bound=1.0)
    one = run_rgps_batch(lqr_adv, jax.random.PRNGKey(3), **rkw)
    shd = run_rgps_batch(lqr_adv, jax.random.PRNGKey(3), mesh=dp, **rkw)
    compare("batched RGPS", shd["trace"], one["trace"], 1e-5)

    print(f"[multichip] time axis over {n} devices", flush=True)
    # (the sequential f32 Riccati class returns NaN beyond T≈200 on
    # LQR-TO-v0 even on the CPU; the horizon stays below that)
    T = 30 * n
    # the time-sharded passes combine block composites in another order than
    # the single-device scan: f32 reassociation over the horizon
    lqr = trajopt_jax.make("LQR-TO-v0")
    r_one = Riccati(lqr, nb_steps=T, init_state=lqr.init())
    c_one = r_one.run()
    r_shd = Riccati(lqr, nb_steps=T, init_state=lqr.init(), mesh=tm)
    c_shd = r_shd.run()
    spread("Riccati(mesh=) gains", r_shd.ctl.K)
    check("Riccati(mesh=) cost", rel_err(c_shd, c_one), 1e-4)

    x0 = jnp.asarray(np.array(pend.x0), jnp.float32)
    one = jax.jit(make_ilqr_solver(pend, T, nb_iter=5, backward="pscan"))(x0)[1]
    shd = jax.jit(make_ilqr_solver(pend, T, nb_iter=5, time_mesh=tm))(x0)[1]
    compare("make_ilqr_solver(time_mesh=) trace", shd, one, 1e-4)

    sig0 = 0.01 * jnp.eye(pend.dm_state, dtype=jnp.float32)
    gk = jax.random.PRNGKey(6)
    one = jax.jit(make_mbgps_solver(pend, T, nb_iter=3, kl_bound=2.0))(gk, x0, sig0)[1]
    shd = jax.jit(make_mbgps_solver(pend, T, nb_iter=3, kl_bound=2.0,
                                    time_mesh=tm))(gk, x0, sig0)[1]
    compare("make_mbgps_solver(time_mesh=) trace", shd, one, 1e-3)

    mu0, sig0 = ld.init()
    mu0, sig0 = f32(mu0), f32(sig0)
    Tb = 25 * n
    one = jax.jit(make_bsp_solver(ld, Tb, nb_iter=5, backward="pscan"))(mu0, sig0)[1]
    shd = jax.jit(make_bsp_solver(ld, Tb, nb_iter=5, time_mesh=tm))(mu0, sig0)[1]
    compare("make_bsp_solver(time_mesh=) trace", shd, one, 1e-4)


# --------------------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    args = ap.parse_args()
    count = 4 if args.multichip else 1
    phase_device(count)
    start = time.perf_counter()
    if args.multichip:
        phase_multichip(jax.devices()[:count])
    else:
        phase_reference()
        env, state = phase_main_path()
        phase_kernels(env, state)
        phase_families()
    print(f"all phases passed in {time.perf_counter() - start:.1f} s", flush=True)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
