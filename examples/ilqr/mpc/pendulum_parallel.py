"""Parallel MPC seeds (mirror of examples/ilqr/mpc/pendulum_parallel.py: 50 episodes
via joblib) — here a sharded batch on the device mesh.  On a GPU the batch-native
solver routes every control step's backward pass through the Pallas kernel (one
kernel call for ALL episodes) instead of N vmapped scans."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup

args = setup()
import jax, numpy as np
from jax.sharding import Mesh
import trajopt_jax
from trajopt_jax.parallel.mpc import run_mpc_batch

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
devs = np.array(jax.devices())
mesh = Mesh(devs, axis_names=("dp",)) if devs.size > 1 else None
on_gpu = devs[0].platform == "gpu"
data = run_mpc_batch(env, jax.random.PRNGKey(0), nb_episodes=48,
                     horizon=25, nb_steps=100, nb_iter=10, mesh=mesh,
                     batched=on_gpu, backward="pallas" if on_gpu else "scan")
returns = np.asarray(data["c"]).sum(axis=1)
print(f"{len(returns)} episodes over {devs.size} device(s) "
      f"({'pallas batch-native' if on_gpu else 'vmapped'}): "
      f"return {returns.mean():.2f} +- {returns.std():.2f}")
