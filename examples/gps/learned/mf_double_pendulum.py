"""Model-free GPS double pendulum (mirror of examples/gps/learned/mf_double_pendulum.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import MFGPS

env = trajopt_jax.make("DoublePendulum-TO-v0", dt=0.05, sigma_scale=1e-4)
solver = MFGPS(env, nb_steps=60, init_state=env.init(), init_action_sigma=2.0,
               kl_bound=5.0, action_penalty=1e-5,
               activation={"mult": 1.0, "shift": 50})
trace = solver.run(nb_iter=10, nb_episodes=64, verbose=True)
print(f"trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, solver.xdist.mu, solver.udist.mu, solver.xdist.sigma)
