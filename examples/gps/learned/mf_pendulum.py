"""Model-free GPS pendulum swing-up (mirror of examples/gps/learned/mf_pendulum.py),
compiled end to end: sampled rollouts, MNIW dynamics regression, and the log-α
dual bisection all run inside one program (parallel/gps.make_mfgps_solver) —
the host SLSQP variant needs a device round trip per dual evaluation."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
from examples._common import setup, plot_trajectory

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.gps import make_mfgps_solver
from trajopt_jax.solvers.common import make_weighting, rollout_batch

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05, sigma_scale=1e-4)
mu0, sigma0 = env.init()
solve = jax.jit(make_mfgps_solver(
    env, nb_steps=60, nb_iter=15, nb_episodes=64, init_action_sigma=2.0,
    kl_bound=5.0, action_penalty=1.0, activation={"mult": 1.0, "shift": 50},
))
(ctl, dyn, last), trace = solve(
    jax.random.PRNGKey(0), jnp.asarray(mu0), jnp.asarray(sigma0)
)
tr = np.asarray(trace)
print(f"trace: {tr[0]:.2f} -> {tr[-1]:.2f}")

weighting = make_weighting(60, {"mult": 1.0, "shift": 50})
data = rollout_batch(env, ctl, jax.random.PRNGKey(1), weighting, 1,
                     stoch_policy=False, init=jnp.asarray(mu0))
plot_trajectory(args, np.asarray(data["x"][0]), np.asarray(data["u"][0]))
