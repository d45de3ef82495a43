"""Model-free GPS on LQR (mirror of examples/gps/learned/mf_lqr.py): dynamics
learned per-timestep by Bayesian linear regression over sampled rollouts."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import MFGPS

env = trajopt_jax.make("LQR-TO-v1", sigma_scale=1e-4)
solver = MFGPS(env, nb_steps=50, init_state=env.init(), init_action_sigma=1.0,
               kl_bound=2.0)
trace = solver.run(nb_iter=10, nb_episodes=64, verbose=True)
print(f"trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, solver.xdist.mu, solver.udist.mu, solver.xdist.sigma)
