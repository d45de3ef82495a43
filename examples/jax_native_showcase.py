"""Tour of the device-native layer — the capabilities the reference has no
analogue for (SURVEY.md §2.4), on whatever devices are attached (works on the
CPU backend too; pass --cpu to force it).

1. batched MPC farm: the 50-process joblib pendulum farm as one sharded program
   (backward='pallas' on a GPU: one Pallas launch per backward pass for all
   episodes)
2. batch-native GPS-MPC: every control step's dual bisection = one batched
   program
3. horizon sharding: exact Riccati with the time axis block-partitioned over a
   mesh, halos exchanged by a log-depth ppermute ladder
4. batch-native exact LQR: N Riccati solves with ONE Pallas backward launch on
   a GPU
5. batch-native eLQR (the reference has no batched eLQR)
6. batch-native belief-space iLQR: per-instance masked lambda escalation
   around one vmapped belief backward per trial
"""
import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from examples._common import setup

args = setup()
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh

import trajopt_jax
from trajopt_jax.parallel.gps import run_gps_mpc_batch
from trajopt_jax.parallel.mesh import make_mesh
from trajopt_jax.parallel.mpc import run_mpc_batch
from trajopt_jax.parallel.riccati import make_riccati_solver_batched
from trajopt_jax.solvers import Riccati

on_gpu = jax.devices()[0].platform == "gpu"
engine = "pallas" if on_gpu else "scan"  # the Pallas kernels compile for the GPU
dtype = jnp.float32 if on_gpu else jnp.asarray(0.0).dtype
mesh = make_mesh(("dp",)) if len(jax.devices()) > 1 else None

env = trajopt_jax.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))

# 1. iLQR-MPC episode farm (examples/ilqr/mpc/pendulum_parallel.py, device-native)
data = run_mpc_batch(env, jax.random.PRNGKey(0), nb_episodes=16, horizon=25,
                     nb_steps=40, nb_iter=6, mesh=mesh, batched=True,
                     backward=engine)
print(f"[1] iLQR-MPC farm: 16 episodes, mean cost "
      f"{float(jnp.mean(jnp.sum(data['c'], axis=1))):.2f}")

# 2. GPS-MPC farm with the batched dual bisection
data = run_gps_mpc_batch(env, jax.random.PRNGKey(1), nb_episodes=8, horizon=15,
                         nb_steps=10, nb_iter=3, kl_bound=2.0, mesh=mesh,
                         batched=True)
print(f"[2] GPS-MPC farm: 8 episodes, mean cost "
      f"{float(jnp.mean(jnp.sum(data['c'], axis=1))):.2f}")

# 3. horizon-sharded exact LQR (sequence-parallel axis)
lqr = trajopt_jax.make("LQR-TO-v0")
tmesh = (Mesh(np.array(jax.devices()), ("time",))
         if len(jax.devices()) > 1 else None)
cost = Riccati(lqr, nb_steps=100, init_state=lqr.init(), mesh=tmesh).run()
print(f"[3] {'time-sharded ' if tmesh else ''}Riccati T=100: cost {cost:.2f}")

# 4. batch of exact-LQR solves, one backward launch
solve = jax.jit(make_riccati_solver_batched(lqr, 100, backward=engine))
mu0, _ = lqr.init()
x0s = jnp.asarray(np.array(mu0))[None] + 0.1 * jax.random.normal(
    jax.random.PRNGKey(2), (32, lqr.dm_state))
_, _, _, costs, div = solve(x0s.astype(dtype))
print(f"[4] batched Riccati x32 ({engine}): mean cost "
      f"{float(jnp.mean(jnp.sum(costs, axis=1))):.2f}, diverged {int(jnp.sum(div))}")

# 5. batch-native eLQR
from trajopt_jax.parallel.elqr import make_elqr_solver_batched

cp = trajopt_jax.make("Cartpole-TO-v0")
solve_elqr = jax.jit(make_elqr_solver_batched(cp, nb_steps=20, nb_iter=4))
keys = jax.random.split(jax.random.PRNGKey(3), 8)
x0e = jnp.zeros((8, cp.dm_state), dtype)
x0e = x0e.at[:, 1].add(0.3 + 0.05 * jnp.arange(8, dtype=x0e.dtype))  # pole tilt
_, _, _, tr = solve_elqr(keys, x0e)
print(f"[5] batched eLQR x8: mean final cost "
      f"{float(jnp.mean(tr[:, -1])):.2f}")

# 6. batch-native belief-space iLQR
from trajopt_jax.parallel.bsp import make_bsp_solver_batched

ld = trajopt_jax.make("LightDark-TO-v0")
solve_bsp = jax.jit(make_bsp_solver_batched(ld, nb_steps=10, nb_iter=5))
mu0, sigma0 = ld.init()
mu0s = jnp.tile(jnp.asarray(np.array(mu0), dtype), (8, 1)) \
    + 0.05 * jnp.arange(8, dtype=dtype)[:, None]
sigma0s = jnp.tile(jnp.asarray(np.array(sigma0), dtype), (8, 1, 1))
state, trace = solve_bsp(mu0s, sigma0s)
print(f"[6] batched BSP-iLQR x8: mean final cost "
      f"{float(jnp.mean(state.last_return)):.2f}")
