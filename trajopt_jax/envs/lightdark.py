"""Light-dark 2D navigation with state-dependent observation noise
(envs/lightdark/lightdark.py) — the canonical BSP-iLQR benchmark."""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
from jax import Array

from .base import BeliefEnv, register

_INF = float("inf")


@dataclass(frozen=True)
class LightDark(BeliefEnv):

    dt: float = 1.0
    state_dim: int = 2
    belief_dim: int = 2
    obs_dim: int = 2
    act_dim: int = 2

    goal: tuple = (0.0, 0.0)
    mu_w: tuple = (0.5, 0.5)
    sigma_w: tuple = (200.0, 0.0)
    act_w: tuple = (0.5, 0.5)

    xmax: tuple = (7.0, 4.0)
    umax: tuple = (_INF, _INF)

    dyn_sigma_scale: float = 1e-8
    obs_sigma_scale: float = 1e-4

    @property
    def dyn_sigma(self):
        return self.dyn_sigma_scale * jnp.eye(self.state_dim)

    @property
    def obs_sigma(self):
        return self.obs_sigma_scale * jnp.eye(self.obs_dim)

    def dynamics(self, x: Array, u: Array) -> Array:
        """Single integrator, clipped (lightdark.py:56-60)."""
        u = self.clip_act(u)
        return jnp.clip(x + self.dt * u, -self.xlim, self.xlim)

    def observe(self, x: Array) -> Array:
        return x

    def obs_noise(self, x: Array) -> Array:
        """Noise grows quadratically with distance from the 'light' at x0 = 5
        (lightdark.py:70-73)."""
        return jnp.asarray(self.obs_sigma) + jnp.array(
            [[0.5 * (5.0 - x[0]) ** 2, 0.0], [0.0, 0.0]]
        )

    def cost(self, mu_b: Array, sigma_b: Array, u: Array) -> Array:
        """Belief cost (μ−g)ᵀWμ(μ−g) + tr(WΣ·Σ) + uᵀRu (lightdark.py:76-79)."""
        g = jnp.asarray(self.goal)
        return (
            (mu_b - g) @ jnp.diag(jnp.asarray(self.mu_w)) @ (mu_b - g)
            + jnp.trace(jnp.diag(jnp.asarray(self.sigma_w)) @ sigma_b)
            + u @ jnp.diag(jnp.asarray(self.act_w)) @ u
        )

    def init(self):
        """Initial belief: wide x-uncertainty (lightdark.py:103-107)."""
        mu = jnp.array([2.0, 2.0])
        sigma = jnp.array([[5.0, 0.0], [0.0, 1e-8]])
        return mu, sigma

    def reset_state(self) -> Array:
        return jnp.array([2.5, 0.0])


register("LightDark-TO-v0", LightDark)
