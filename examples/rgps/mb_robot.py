"""MBRGPS on the robot env (mirror of examples/rgps/mb_robot.py, scaled down from
900 outer iterations)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import MBRGPS

env = trajopt_jax.make("Robot-TO-v0", sigma_scale=1e-4)
solver = MBRGPS(env, nb_steps=50, init_state=env.init(), init_action_sigma=1.0,
                policy_kl_bound=1.0, param_nominal_kl_bound=50.0,
                nominal_variance=1e-8)
trace = solver.run(nb_iter=10, verbose=True)
print(f"trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, solver.xdist.mu, solver.udist.mu, solver.xdist.sigma)
