"""Cross-solver oracle: MBGPS vs exact Riccati on the same LQR task
(mirror of examples/gps/analytical/topt/mbgps_riccati.py:20-41)."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))
from examples._common import setup

args = setup()
import jax, numpy as np
import trajopt_jax
from trajopt_jax.solvers import MBGPS, Riccati

env = trajopt_jax.make("LQR-TO-v0")

mbgps = MBGPS(env, nb_steps=100, init_state=env.init(), init_action_sigma=100.0,
              kl_bound=5.0)
mbgps.run(nb_iter=15, verbose=True)

riccati = Riccati(env, nb_steps=100, init_state=env.init())
riccati.run(); riccati.run()

key = jax.random.PRNGKey(1337)
from trajopt_jax.solvers.common import rollout_batch
gps_data = rollout_batch(env, mbgps.ctl, key, mbgps.weighting, 250, stoch_policy=False)
ric_data = riccati.rollout(key, 250)

print("GPS Cost: ", float(np.mean(np.sum(np.asarray(gps_data["c"]), axis=1))),
      ", Riccati Cost", float(np.mean(np.sum(np.asarray(ric_data["c"]), axis=1))))
