"""Parallel MBGPS-MPC cartpole episodes (mirror of .../mpc/mb_cartpole_parallel.py)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.solvers import MBGPS

env = trajopt_jax.make("Cartpole-TO-v0", dt=0.05, umax=(5.0,), periodic=True)
returns = []
for ep in range(2):
    key = jax.random.PRNGKey(ep)
    x = env.sample_init(key)
    total = 0.0
    for t in range(50):
        solver = MBGPS(env, nb_steps=20, init_state=(x, jnp.asarray(env.sigma)),
                       init_action_sigma=1.0, kl_bound=2.0, action_penalty=1e-5)
        solver.run(nb_iter=3)
        u = jnp.clip(solver.ctl.mean(x, 0), -env.ulim, env.ulim)
        total += float(env.cost(x, u, u, 1.0))
        key, k = jax.random.split(key)
        x = env.step(k, x, u)
    returns.append(total)
    print(f"episode {ep}: {total:.2f}")
print(f"mean {np.mean(returns):.2f}")
