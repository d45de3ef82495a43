"""Pendulum MPC via iLQR (mirror of examples/ilqr/mpc/pendulum.py: horizon 25,
100 control steps, 10 iLQR iters/step) — here the full MPC loop is one compiled
scan instead of re-instantiating a Python solver per step."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.mpc import make_mpc_runner

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
run = jax.jit(make_mpc_runner(env, horizon=25, nb_steps=100, nb_iter=10))
states, actions, costs = run(jax.random.PRNGKey(0), jnp.asarray(np.array(env.x0)))
print(f"MPC pendulum: total cost {float(costs.sum()):.2f}, "
      f"final state {np.asarray(states[-1])}")
plot_trajectory(args, states, actions)
