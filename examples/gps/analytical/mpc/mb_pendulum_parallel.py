"""Parallel MBGPS-MPC pendulum episodes (mirror of the reference's
examples/gps/analytical/mpc/mb_pendulum_parallel.py 50-job joblib farm).

The whole farm is ONE compiled device program: per control step a full MBGPS
solve (jit-safe log-α dual bisection, parallel/gps.py) vmapped over the episode
batch — no process pool, no per-step solver re-instantiation."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup

args = setup()
import jax, numpy as np
import trajopt_jax
from trajopt_jax.parallel.gps import run_gps_mpc_batch

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
data = run_gps_mpc_batch(
    env, jax.random.PRNGKey(0), nb_episodes=8, horizon=20, nb_steps=50,
    nb_iter=3, kl_bound=2.0, action_penalty=1e-5,
)
returns = np.asarray(data["c"]).sum(axis=1)
print(f"{len(returns)} compiled GPS-MPC episodes: "
      f"return {returns.mean():.2f} +- {returns.std():.2f}")
