"""LQR task via iLQR (mirror of examples/ilqr/mpc/lqr.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.solvers import iLQR

env = trajopt_jax.make("LQR-TO-v0")
solver = iLQR(env, nb_steps=60, init_state=jnp.asarray(np.array(env.x0)))
trace = solver.run(nb_iter=25)
print(f"iLQR LQR: {trace[0]:.2f} -> {trace[-1]:.2f} in {len(trace)-1} accepted iters")
plot_trajectory(args, solver.xref, solver.uref)
