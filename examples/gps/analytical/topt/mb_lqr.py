"""MBGPS on LQR (mirror of .../topt/mb_lqr.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import MBGPS

env = trajopt_jax.make("LQR-TO-v0")
solver = MBGPS(env, nb_steps=100, init_state=env.init(), init_action_sigma=100.0,
               kl_bound=5.0)
trace = solver.run(nb_iter=15, verbose=True)
print(f"trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, solver.xdist.mu, solver.udist.mu, solver.xdist.sigma)
