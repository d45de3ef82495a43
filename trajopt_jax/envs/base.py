"""Pure-function environment protocol and registry.

The reference wraps every system in a ``gym.Env`` with autograd-differentiable
``dynamics/cost/noise`` methods plus stateful ``step/reset`` (e.g.
envs/pendulum/pendulum.py:15-149).  Here an environment is an immutable dataclass of
parameters whose methods are **pure jittable functions** — state and randomness are
explicit, so whole rollouts compile into single ``lax.scan`` programs and batch/shard
cleanly.

Protocol (mirrors the reference env surface, SURVEY.md §2.2):

* ``dynamics(x, u) -> xn``            — deterministic, action/state clipped.
* ``cost(x, u, u_last, a) -> scalar`` — activation-weighted, optional slew-rate.
* ``noise(x, u) -> (dx, dx)``         — process-noise covariance.
* ``init() -> (x0, sigma0)``          — initial state distribution.
* ``sample_init(key) / step(key, x, u)`` — explicit-randomness analogues of
  gym ``reset``/``step``.

Belief-space environments additionally provide ``observe``, ``dyn_noise``,
``obs_noise`` and a belief cost (lightdark.py:62-79).  Adversarial LQR variants
provide ``evolve`` (lqr_v1.py:95-103).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
from jax import Array


def wrap_angle(x: Array) -> Array:
    """Wrap angle to [-π, π) (envs/pendulum/pendulum.py:10-12)."""
    return ((x + jnp.pi) % (2.0 * jnp.pi)) - jnp.pi


def rk4(f: Callable, x: Array, u: Array, dt: float) -> Array:
    """Classic RK4 step used by every analytic env (pendulum.py:68-73)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_backward(f: Callable, x: Array, u: Array, dt: float) -> Array:
    """Backward-sign RK4 used by ``inverse_dynamics`` (pendulum.py:78-96) and by the
    Robot env's forward dynamics (robot.py:51-70)."""
    k1 = f(x, u)
    k2 = f(x - 0.5 * dt * k1, u)
    k3 = f(x - 0.5 * dt * k2, u)
    k4 = f(x - dt * k3, u)
    return x - dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@dataclass(frozen=True)
class TrajEnv:
    """Base fully-observed environment. Subclasses define ``_ode`` or ``dynamics``."""

    dt: float
    dm_state: int
    dm_act: int

    def replace(self, **kwargs) -> "TrajEnv":
        return dataclasses.replace(self, **kwargs)

    # -- limits ------------------------------------------------------------------
    @property
    def xlim(self) -> Array:
        return jnp.asarray(self.xmax)

    @property
    def ulim(self) -> Array:
        return jnp.asarray(self.umax)

    def clip_act(self, u: Array) -> Array:
        return jnp.clip(u, -self.ulim, self.ulim)

    def clip_state(self, x: Array) -> Array:
        return jnp.clip(x, -self.xlim, self.xlim)

    # -- tile-level protocol (component-wise physics) ------------------------------
    # Envs that define ``_ode_parts(x, u) -> tuple`` (indexing x[i]/u[j] and
    # returning per-component derivatives) get two things for free: the stacked
    # ``_ode`` below, and eligibility for the Pallas rollout kernel
    # (core/pallas_rollout.py), which calls ``_ode_parts`` with *lists of
    # tiles* — each component one (candidates, instances) block of values.
    def _ode_parts(self, x, u) -> tuple:
        raise NotImplementedError(
            f"{type(self).__name__} does not define component-wise dynamics"
        )

    def _ode(self, x: Array, u: Array) -> Array:
        return jnp.stack(self._ode_parts(x, u))

    def _periodic_parts(self, x) -> tuple:
        """Component-wise ``_periodic_state`` (identity unless periodic)."""
        if getattr(self, "periodic", False):
            raise NotImplementedError(
                f"{type(self).__name__} is periodic but defines no _periodic_parts"
            )
        return tuple(x[i] for i in range(self.dm_state))

    def features_parts(self, x) -> tuple:
        """Component-wise ``features`` (identity by default)."""
        return tuple(x[i] for i in range(self.dm_state))

    # Envs whose ``dynamics`` integrates with backward RK4 signs (Robot,
    # robot.py:62-67) set this class attribute so the tile kernels pick the
    # matching integrator.  Plain class attr, not a dataclass field.
    rk4_backward_integration = False

    def cost_parts(self, x, u, u_last, w):
        """``cost`` on tiles — only needed by envs that override ``cost``
        away from the standard uᵀdiag(uw)u/slew + w·feature-goal form (the
        tile kernels evaluate that form directly otherwise)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a tile-level cost"
        )

    @property
    def supports_tiles(self) -> bool:
        """True when the env opts into the tile-level protocol.

        Defining ``_ode_parts`` is the opt-in, but the tile kernels also
        consume ``features_parts``/``_periodic_parts`` (identity by default)
        and the standard cost form — an env that overrides ``features``/
        ``_periodic_state``/``cost`` without the matching parts form would
        silently cost trajectories wrongly, so such envs are NOT
        tile-eligible."""
        cls = type(self)
        if cls._ode_parts is TrajEnv._ode_parts:
            return False
        if (cls.features is not TrajEnv.features
                and cls.features_parts is TrajEnv.features_parts):
            return False
        if (cls._periodic_state is not TrajEnv._periodic_state
                and cls._periodic_parts is TrajEnv._periodic_parts):
            return False
        if (cls.cost is not TrajEnv.cost
                and cls.cost_parts is TrajEnv.cost_parts):
            return False
        return True

    # -- core protocol -----------------------------------------------------------
    def dynamics(self, x: Array, u: Array) -> Array:
        u = self.clip_act(u)
        return self.clip_state(rk4(self._ode, x, u, self.dt))

    def inverse_dynamics(self, x: Array, u: Array) -> Array:
        u = self.clip_act(u)
        return self.clip_state(rk4_backward(self._ode, x, u, self.dt))

    def noise(self, x: Array | None = None, u: Array | None = None) -> Array:
        return jnp.asarray(self.sigma)

    def features(self, x: Array) -> Array:
        return x

    def _feature_goal_cost(self, x: Array, a) -> Array:
        """Goal cost through the detached-Jacobian feature linearization.

        Replicates the ``getval``-based pattern (pendulum.py:121-123): the feature map
        is linearized around stop_gradient(y), so cost curvature comes only from the
        quadratic form, not from feature curvature.
        """
        y = self._periodic_state(x)
        y0 = jax.lax.stop_gradient(y)
        J = jax.jacfwd(self.features)(y0)
        z = J @ y + (self.features(y0) - J @ y0)
        g = jnp.asarray(self.g)
        gw = jnp.asarray(self.gw)
        return a * (z - g) @ jnp.diag(gw) @ (z - g)

    def _periodic_state(self, x: Array) -> Array:
        return x

    def cost(self, x: Array, u: Array, u_last: Array, a) -> Array:
        uw = jnp.asarray(self.uw)
        if self.slew_rate:
            c = (u - u_last) @ jnp.diag(uw) @ (u - u_last)
        else:
            c = u @ jnp.diag(uw) @ u
        return c + self._feature_goal_cost(x, a)

    # -- stochastic interface ------------------------------------------------------
    def init(self) -> tuple[Array, Array]:
        return jnp.asarray(self.x0), jnp.asarray(self.sigma0)

    def sample_init(self, key: Array) -> Array:
        x0, sigma0 = self.init()
        return jax.random.multivariate_normal(key, x0, sigma0)

    def step(self, key: Array, x: Array, u: Array) -> Array:
        """Noisy step: dynamics + Gaussian process noise (pendulum.py:131-138)."""
        sig = self.noise(x, u)
        xn = self.dynamics(x, u)
        return jax.random.multivariate_normal(key, xn, sig)


@dataclass(frozen=True)
class BeliefEnv:
    """Base partially-observed environment (lightdark.py, car.py)."""

    dt: float
    state_dim: int
    belief_dim: int
    obs_dim: int
    act_dim: int

    def replace(self, **kwargs) -> "BeliefEnv":
        return dataclasses.replace(self, **kwargs)

    @property
    def xlim(self) -> Array:
        return jnp.asarray(self.xmax)

    @property
    def ulim(self) -> Array:
        return jnp.asarray(self.umax)

    def clip_act(self, u: Array) -> Array:
        return jnp.clip(u, -self.ulim, self.ulim)

    def dynamics(self, x: Array, u: Array) -> Array:
        u = self.clip_act(u)
        return jnp.clip(rk4(self._ode, x, u, self.dt), -self.xlim, self.xlim)

    def dyn_noise(self, x: Array | None = None, u: Array | None = None) -> Array:
        return jnp.asarray(self.dyn_sigma)

    def obs_noise(self, x: Array) -> Array:
        return jnp.asarray(self.obs_sigma)

    def observe(self, x: Array) -> Array:
        return x

    def step(self, key: Array, x: Array, u: Array) -> tuple[Array, Array]:
        """Noisy step returning (next state, noisy observation) — lightdark.py:85-100."""
        k1, k2 = jax.random.split(key)
        xn = jax.random.multivariate_normal(k1, self.dynamics(x, u), self.dyn_noise(x, u))
        obs = jax.random.multivariate_normal(k2, self.observe(xn), self.obs_noise(xn))
        return xn, obs


# ---------------------------------------------------------------------------------
# Registry — same ids as the reference (trajopt/__init__.py:3-97)
# ---------------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], object]] = {}


def register(name: str, ctor: Callable[[], object]) -> None:
    _REGISTRY[name] = ctor


def make(name: str, **overrides):
    """Instantiate a registered environment, optionally overriding parameter fields
    (the analogue of the reference's ``env.unwrapped.attr = ...`` mutation pattern)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; known: {sorted(_REGISTRY)}")
    env = _REGISTRY[name]()
    if overrides:
        env = dataclasses.replace(env, **overrides)
    return env


def registered() -> list[str]:
    return sorted(_REGISTRY)
