"""Belief-space iLQR MPC on the light-dark task (mirror of
examples/bspilqr/lightdark.py: EKF state estimation + receding-horizon replanning)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.core.ekf import EKF
from trajopt_jax.solvers import BSPiLQR

env = trajopt_jax.make("LightDark-TO-v0")
nb_steps = 25
key = jax.random.PRNGKey(0)

x = env.reset_state()
mu_b, sigma_b = env.init()
filt = EKF(env)
# innovate on the first observation (lightdark.py:34-37)
key, k = jax.random.split(key)
obs = jax.random.multivariate_normal(k, env.observe(x), env.obs_noise(x))
mu_b, sigma_b = filt.innovate(mu_b, sigma_b, obs)

mus, acts = [np.asarray(mu_b)], []
for t in range(nb_steps):
    solver = BSPiLQR(env, nb_steps=10, init_belief=(mu_b, sigma_b))
    trace = solver.run(nb_iter=25)
    u = solver.uref[0]
    key, k = jax.random.split(key)
    x, obs = env.step(k, x, u)
    mu_b, sigma_b = filt.inference(mu_b, sigma_b, u, obs)
    mus.append(np.asarray(mu_b)); acts.append(np.asarray(u))
    print(f"step {t}: cost {trace[-1]:.2f}, belief {np.asarray(mu_b)}, "
          f"sigma_xx {float(sigma_b[0,0]):.4f}")
print(f"final true state: {np.asarray(x)}")
plot_trajectory(args, np.stack(mus), np.stack(acts))
