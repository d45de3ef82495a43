"""Robust-vs-standard GPS ablation on the adversarial LQR env (mirror of
examples/rgps/mb_lqr.py:44-111): train LRGPS with and without the adversary,
compute the worst-case parameter attack on the STANDARD controller
(mb_lqr.py:74-75), and compare both controllers' expected costs under the
nominal and attacked dynamics — the robust controller should pay a small
premium on the nominal model and win under attack.

Retuned vs the reference script: param_nominal_kl_bound 100 -> 400 and
nb_iter 15 -> 25, because the jit-safe geometric-bisection duals accept more
conservative adversary steps per outer iteration than the reference's scipy
optimizers; the larger budget reproduces the reference's qualitative
robust-vs-standard gap."""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from examples._common import setup

args = setup()
import jax.numpy as jnp, numpy as np
import trajopt_jax
from trajopt_jax.solvers import LRGPS

env = trajopt_jax.make("LQR-TO-v1", sigma_scale=1e-4)
kwargs = dict(nb_steps=40, init_state=env.init(), init_action_sigma=100.0,
              policy_kl_bound=0.25, param_nominal_kl_bound=400.0,
              param_regularizer_kl_bound=10.0)

rgps = LRGPS(env, **kwargs)
rgps_trace = rgps.run(nb_iter=25, verbose=True)

gps = LRGPS(env, **kwargs)
gps_trace = gps.run(nb_iter=25, verbose=True, optimize_adversary=False)

# worst-case attack on the final STANDARD controller (mb_lqr.py:74-75; the
# reference uses the iterated small-KL adversary — here the direct β-bisection
# attack spends the same KL-to-nominal budget in one solve)
attack, _ = gps.parameter_optimization(gps.ctl)
print("attack KL to nominal:", float(jnp.sum(gps.parameter_nominal_kldiv(attack))))


def expected_cost(solver, ctl, param):
    xd, ud, _ = solver._cubature(ctl, param)
    return solver._expected_cost(xd, ud)


print("\n            nominal       attacked")
print(f"standard {expected_cost(gps, gps.ctl, gps.nominal):10.2f} "
      f"{expected_cost(gps, gps.ctl, attack):12.2f}")
print(f"robust   {expected_cost(rgps, rgps.ctl, rgps.nominal):10.2f} "
      f"{expected_cost(rgps, rgps.ctl, attack):12.2f}")
