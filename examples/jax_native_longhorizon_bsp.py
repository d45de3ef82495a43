"""Long-horizon belief-space planning with the parallel-in-time backward pass.

No analogue exists in the reference: its belief-space example is horizon-25 MPC
(examples/bspilqr/lightdark.py:34-45) and its (S, s, τ) backward recursion is an
inherently sequential C++ loop (bspilqr/src/util.cpp:83-204).  Here the same
recursion decomposes into two associative ladders (core/pscan_lqr.
sharded_bsp_backward: Riccati-element ladder for S, affine suffix ladder for the
coupled (s, τ) channel), so a horizon-1000 belief plan runs in O(log T) parallel
depth — and the horizon can be block-sharded across a device mesh
(``make_bsp_solver(time_mesh=…)``) with composites exchanged by a log-depth
ppermute ladder.

This script solves a long-horizon light-dark homing problem with both backward
engines and reports agreement and (on a GPU) per-solve timings.
"""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from examples._common import plot_trajectory, setup

args = setup()
import time

import jax
import jax.numpy as jnp
import numpy as np

import trajopt_jax
from trajopt_jax.parallel.bsp import make_bsp_solver

T, nb_iter = 400, 15
env = trajopt_jax.make("LightDark-TO-v0")
mu0, sigma0 = env.init()
mu0, sigma0 = jnp.asarray(mu0), jnp.asarray(sigma0)

solve_scan = jax.jit(make_bsp_solver(env, nb_steps=T, nb_iter=nb_iter))
solve_pscan = jax.jit(
    make_bsp_solver(env, nb_steps=T, nb_iter=nb_iter, backward="pscan")
)


def run(solve, tag):
    state, trace = jax.block_until_ready(solve(mu0, sigma0))
    t0 = time.perf_counter()
    state, trace = jax.block_until_ready(solve(mu0, sigma0))
    dt = time.perf_counter() - t0
    print(f"{tag:>6}: return {float(trace[-1]):.3f}  "
          f"(wall {dt * 1e3:.1f} ms/solve incl. dispatch)")
    return state, trace


st_s, tr_s = run(solve_scan, "scan")
st_p, tr_p = run(solve_pscan, "pscan")

# both engines are exact at λ = 0 and proximal variants of each other beyond —
# on this problem they converge to the same plan
rel = abs(float(tr_p[-1]) - float(tr_s[-1])) / abs(float(tr_s[-1]))
print(f"converged-objective relative difference: {rel:.2e}")
assert rel < 5e-2

plot_trajectory(args, st_p.bref_mu, st_p.uref)
