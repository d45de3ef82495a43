"""MBGPS MPC on the double cartpole (mirror of .../mpc/mb_double_cartpole.py),
compiled end to end (parallel/gps.make_gps_mpc_runner)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.gps import make_gps_mpc_runner

env = trajopt_jax.make("DoubleCartpole-TO-v0", dt=0.05)
run = jax.jit(make_gps_mpc_runner(env, horizon=20, nb_steps=60, nb_iter=3,
                                  init_action_sigma=1.0, kl_bound=2.0,
                                  action_penalty=1e-5))
xs, us, cs = run(jax.random.PRNGKey(0), env.sample_init(jax.random.PRNGKey(0)))
print(f"accumulated cost: {float(jnp.sum(cs)):.2f}, final state: {np.asarray(xs[-1])}")
plot_trajectory(args, np.asarray(xs), np.asarray(us))
