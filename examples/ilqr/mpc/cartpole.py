"""Cartpole MPC via iLQR (mirror of examples/ilqr/mpc/cartpole.py: Cartesian cost,
dt=0.02, horizon 50, 250 steps)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.mpc import make_mpc_runner

env = trajopt_jax.make("Cartpole-TO-v1", dt=0.02).replace(uw=(1e-5,))
run = jax.jit(make_mpc_runner(env, horizon=50, nb_steps=250, nb_iter=10))
states, actions, costs = run(jax.random.PRNGKey(0), jnp.asarray(np.array(env.x0)))
th = float(states[-1, 1])
print(f"MPC cartpole: total cost {float(costs.sum()):.2f}, final theta {th:.3f}")
plot_trajectory(args, states, actions)
