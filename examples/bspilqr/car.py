"""Belief-space iLQR MPC on the partially-observed car (mirror of
examples/bspilqr/car.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.core.ekf import EKF
from trajopt_jax.solvers import BSPiLQR

env = trajopt_jax.make("Car-TO-v0")
nb_steps = 15
key = jax.random.PRNGKey(0)

x = env.reset_state()
mu_b, sigma_b = env.init()
filt = EKF(env)

mus, acts = [np.asarray(mu_b)], []
for t in range(nb_steps):
    solver = BSPiLQR(env, nb_steps=8, init_belief=(mu_b, sigma_b))
    trace = solver.run(nb_iter=15)
    u = solver.uref[0]
    key, k = jax.random.split(key)
    x, obs = env.step(k, x, u)
    mu_b, sigma_b = filt.inference(mu_b, sigma_b, u, obs)
    mus.append(np.asarray(mu_b)); acts.append(np.asarray(u))
    print(f"step {t}: cost {trace[-1]:.2f}, |mu-goal| "
          f"{float(jnp.linalg.norm(mu_b - jnp.asarray(env.goal))):.3f}")
plot_trajectory(args, np.stack(mus), np.stack(acts))
