"""Robust inverse optimal control: gradients THROUGH the compiled min-max solve.

Companion to examples/jax_native_ioc.py for the distributionally-robust family.
The reference's robust GPS (rgps/mbrgps.py) is a host loop around scipy duals and
pybind kernels — a loss on the ROBUST controller has no gradient path back to the
cost parameters.  Here the full min-max alternation (adversary β-bisection +
fixed point, policy KL dual, acceptance) is one reverse-differentiable XLA
program (`make_rgps_solver(differentiable=True)`, parallel/rgps.py), so learning
cost weights whose ROBUST optimal controller imitates an expert is `optax.adam`
on `jax.grad(imitation_loss)`:

  1. generate the "expert" robust controller at hidden true weights gw*;
  2. start from wrong weights, descend mean ||K(gw) − K*||² + ||kff(gw) − kff*||²
     where (K, kff) is the CONVERGED robust-GPS policy;
  3. recover weights whose robust controller reproduces the expert's.
"""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from examples._common import setup

setup()
import jax, jax.numpy as jnp, numpy as np
import optax

import trajopt_jax
from trajopt_jax.parallel.rgps import make_rgps_solver

T, nb_iter = 10, 2
env = trajopt_jax.make("LQR-TO-v1")
mu0, sigma0 = env.init()
mu0, sigma0 = jnp.asarray(mu0), jnp.asarray(sigma0)

KW = dict(
    nb_steps=T, variant="lr", nb_iter=nb_iter, init_action_sigma=10.0,
    policy_kl_bound=0.25, param_nominal_kl_bound=50.0,
    beta_iters=6, fp_iters=12, alpha_bisect_iters=32, differentiable=True,
)


def robust_ctl(log_gw):
    e = env.replace(gw=jnp.exp(log_gw))  # positivity via exp
    state, _ = make_rgps_solver(e, **KW)(mu0, sigma0)
    return state.ctl


log_gw_true = jnp.log(jnp.asarray([1e2, 1e0]))
expert = jax.jit(robust_ctl)(log_gw_true)


@jax.jit
def loss(p):
    ctl = robust_ctl(p)
    return jnp.mean((ctl.K - expert.K) ** 2) + jnp.mean(
        (ctl.kff - expert.kff) ** 2
    )


grad = jax.jit(jax.grad(loss))
params = jnp.log(jnp.asarray([3e2, 3e0]))  # wrong initial weights
opt = optax.adam(0.2)
opt_state = opt.init(params)

print(f"true gw = {np.exp(np.asarray(log_gw_true))}")
start = float(loss(params))
for it in range(40):
    g = grad(params)
    updates, opt_state = opt.update(g, opt_state)
    params = optax.apply_updates(params, updates)
    if it % 5 == 0 or it == 39:
        print(f"iter {it:3d}  loss {float(loss(params)):.3e}  "
              f"gw {np.exp(np.asarray(params))}")

final = float(loss(params))
print(f"robust imitation loss: {start:.3e} -> {final:.3e}")
assert final < 1e-2 * start, "robust IOC failed to recover expert behavior"
