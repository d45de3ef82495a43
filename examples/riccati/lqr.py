"""Exact LQR via one Riccati sweep (mirror of examples/riccati/lqr.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from examples._common import setup, plot_trajectory

args = setup()
import trajopt_jax
from trajopt_jax.solvers import Riccati

env = trajopt_jax.make("LQR-TO-v0")
alg = Riccati(env, nb_steps=60, init_state=env.init())
cost = alg.run()
print(f"Riccati LQR cost: {cost:.4f}")
plot_trajectory(args, alg.xref, alg.uref)
