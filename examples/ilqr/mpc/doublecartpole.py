"""Double-cartpole MPC via iLQR (mirror of examples/ilqr/mpc/doublecartpole.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.mpc import make_mpc_runner

env = trajopt_jax.make("DoubleCartpole-TO-v1", dt=0.02).replace(uw=(1e-5,))
run = jax.jit(make_mpc_runner(env, horizon=50, nb_steps=150, nb_iter=10))
states, actions, costs = run(jax.random.PRNGKey(0), jnp.asarray(np.array(env.x0)))
print(f"MPC double-cartpole: total cost {float(costs.sum()):.2f}")
plot_trajectory(args, states, actions)
