"""Inverse optimal control by differentiating THROUGH the compiled iLQR solve.

No analogue exists in the reference: its solver is a Python loop around opaque
pybind/Armadillo kernels (ilqr/ilqr.py:136-237), so a loss on the solver OUTPUT
has no gradient path back to the cost parameters.  Here the whole solve is one
reverse-differentiable XLA program (parallel/diffmpc.py), so learning cost
weights from expert demonstrations is literally `optax.adam` on
`jax.grad(imitation_loss)`:

  1. generate "expert" trajectories with hidden true cost weights gw*;
  2. start from wrong weights, descend the imitation loss
     mean ||u(gw) - u*||^2, where u(gw) is the CONVERGED iLQR solution;
  3. recover weights that reproduce the expert behavior.
"""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from examples._common import setup

setup()
import jax, jax.numpy as jnp, numpy as np
import optax

import trajopt_jax
from trajopt_jax.parallel.diffmpc import make_ilqr_solver_diff

T, nb_iter, N = 25, 5, 4
env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05)

rng = np.random.default_rng(0)
x0s = jnp.asarray(np.asarray(env.x0)[None] + 0.05 * rng.standard_normal((N, 2)))

# solve(x0s, log_gw): positivity via exp, gradients flow through env.replace
solve = make_ilqr_solver_diff(
    env, T, nb_iter=nb_iter, param_apply=lambda e, p: e.replace(gw=jnp.exp(p))
)

log_gw_true = jnp.log(jnp.asarray([1.0, 0.1]))
expert, _ = jax.jit(solve)(x0s, log_gw_true)


@jax.jit
def loss(p):
    state, _ = solve(x0s, p)
    return jnp.mean((state.uref - expert.uref) ** 2)


grad = jax.jit(jax.grad(loss))
params = jnp.log(jnp.asarray([3.0, 0.02]))  # wrong initial weights
# the loss is weakly identified along the overall cost-scale direction (only the
# fixed action penalty uw pins it), so anneal the step size to settle
opt = optax.adam(optax.exponential_decay(0.2, 10, 0.7))
opt_state = opt.init(params)

print(f"true gw = {np.exp(np.asarray(log_gw_true))}")
start = float(loss(params))
for it in range(80):
    g = grad(params)
    updates, opt_state = opt.update(g, opt_state)
    params = optax.apply_updates(params, updates)
    if it % 10 == 0 or it == 79:
        print(f"iter {it:3d}  loss {float(loss(params)):.3e}  "
              f"gw {np.exp(np.asarray(params))}")

final = float(loss(params))
print(f"imitation loss: {start:.3e} -> {final:.3e}")
assert final < 1e-2 * start, "IOC failed to recover expert behavior"
