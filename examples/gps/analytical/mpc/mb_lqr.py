"""MBGPS MPC on LQR (mirror of examples/gps/analytical/mpc/mb_lqr.py).

The reference re-instantiates the SLSQP-driven solver at every control step;
on an accelerator every dual evaluation would be a host-device round trip, so
this runs the whole receding-horizon loop as ONE compiled program
(parallel/gps.make_gps_mpc_runner: log-alpha bisection dual, lax.scan over
control steps).

Retuned vs the reference script: kl_bound 5.0 -> 50.0 and nb_iter 5 -> 10,
because the compiled bisection dual takes smaller, better-vetted steps per
iteration than SLSQP and needs the looser per-step KL budget to make the same
receding-horizon progress."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup

args = setup()
import jax, jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.parallel.gps import make_gps_mpc_runner

env = trajopt_jax.make("LQR-TO-v0")
run = jax.jit(make_gps_mpc_runner(env, horizon=20, nb_steps=50, nb_iter=10,
                                  init_action_sigma=10.0, kl_bound=50.0))
xs, us, cs = run(jax.random.PRNGKey(0), env.sample_init(jax.random.PRNGKey(0)))
print(f"MPC LQR accumulated cost: {float(jnp.sum(cs)):.2f}, "
      f"final state {np.asarray(xs[-1])}")
