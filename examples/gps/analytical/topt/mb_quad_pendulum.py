"""MBGPS quad-pendulum (mirror of .../topt/mb_quad_pendulum.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import MBGPS

env = trajopt_jax.make("QuadPendulum-TO-v0", dt=0.05)
solver = MBGPS(env, nb_steps=60, init_state=env.init(), init_action_sigma=5.0,
               kl_bound=10.0, action_penalty=1e-5,
               activation={"mult": 1.0, "shift": 50})
trace = solver.run(nb_iter=15, verbose=True)
print(f"trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, solver.xdist.mu, solver.udist.mu, solver.xdist.sigma)
