"""eLQR pendulum (mirror of examples/elqr/pendulum.py: horizon 100)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from examples._common import setup, plot_trajectory

args = setup()
import numpy as np
import trajopt_jax
from trajopt_jax.solvers import eLQR

env = trajopt_jax.make("Pendulum-TO-v0")
alg = eLQR(env, nb_steps=100, init_state=np.array(env.x0))
trace = alg.run(nb_iter=10)
print(f"eLQR pendulum trace: {trace[0]:.2f} -> {trace[-1]:.2f}")
plot_trajectory(args, alg.xref, alg.uref)
