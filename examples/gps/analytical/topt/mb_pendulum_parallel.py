"""Batch of independent MBGPS pendulum solves from sampled starts (mirror of
.../topt/mb_pendulum_parallel.py: the reference's 50 joblib jobs become ONE
compiled batch-native solve — per-instance log-α dual bisections in lockstep,
parallel/gps.make_mbgps_solver_batched)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.gps import make_mbgps_solver_batched

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
N = 8
keys = jax.random.split(jax.random.PRNGKey(0), N)
x0s = jax.vmap(env.sample_init)(keys)
sigma0s = jnp.tile(jnp.asarray(env.init()[1]), (N, 1, 1))

solve = jax.jit(make_mbgps_solver_batched(
    env, nb_steps=100, nb_iter=10, init_action_sigma=5.0, kl_bound=10.0,
    action_penalty=1.0, activation={"mult": 1.0, "shift": 80},
))
state, traces = solve(keys, x0s, sigma0s)
returns = np.asarray(traces[:, -1])
for i, r in enumerate(returns):
    print(f"episode {i}: {r:.2f}")
print(f"mean return {returns.mean():.2f} +- {returns.std():.2f}")
