"""MBGPS pendulum swing-up (mirror of examples/gps/analytical/topt/mb_pendulum.py:
horizon 100, 25 iters, sigmoid activation shift 80)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import MBGPS

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)
solver = MBGPS(env, nb_steps=100, init_state=env.init(), init_action_sigma=5.0,
               kl_bound=10.0, action_penalty=1.0,
               activation={"mult": 1.0, "shift": 80})
trace = solver.run(nb_iter=25, verbose=True)
print(f"trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, solver.xdist.mu, solver.udist.mu, solver.xdist.sigma)
