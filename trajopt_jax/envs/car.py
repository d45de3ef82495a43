"""Partially-observed bicycle-model car (envs/car/car.py) — BSP-iLQR benchmark with
position-only observations and light-dark noise."""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
from jax import Array

from .base import BeliefEnv, register

_INF = float("inf")


@dataclass(frozen=True)
class Car(BeliefEnv):

    dt: float = 0.5
    state_dim: int = 4
    belief_dim: int = 4
    obs_dim: int = 2
    act_dim: int = 2

    length: float = 0.1  # car length (car.py:24)

    goal: tuple = (0.0, 0.0, 0.0, 0.0)
    mu_w: tuple = (100.0, 100.0, 100.0, 100.0)
    sigma_w: tuple = (100.0, 100.0, 100.0, 100.0)
    act_w: tuple = (1.0, 1.0)

    xmax: tuple = (_INF, _INF, _INF, _INF)
    umax: tuple = (_INF, _INF)

    dyn_sigma_scale: float = 1e-8
    obs_sigma_scale: float = 1e-8

    @property
    def dyn_sigma(self):
        return self.dyn_sigma_scale * jnp.eye(self.state_dim)

    @property
    def obs_sigma(self):
        return self.obs_sigma_scale * jnp.eye(self.obs_dim)

    def _ode(self, x: Array, u: Array) -> Array:
        """Bicycle model (car.py:62-66): state (x, y, θ, v), action (accel, steer)."""
        return jnp.stack(
            [
                x[3] * jnp.cos(x[2]),
                x[3] * jnp.sin(x[2]),
                x[3] * jnp.tan(u[1]) / self.length,
                u[0],
            ]
        )

    def observe(self, x: Array) -> Array:
        """Position-only observation (car.py:78-79)."""
        return x[:2]

    def obs_noise(self, x: Array) -> Array:
        """Same light-dark noise profile as LightDark (car.py:86-89)."""
        return jnp.asarray(self.obs_sigma) + jnp.array(
            [[0.5 * (5.0 - x[0]) ** 2, 0.0], [0.0, 0.0]]
        )

    def cost(self, mu_b: Array, sigma_b: Array, u: Array) -> Array:
        g = jnp.asarray(self.goal)
        return (
            (mu_b - g) @ jnp.diag(jnp.asarray(self.mu_w)) @ (mu_b - g)
            + jnp.trace(jnp.diag(jnp.asarray(self.sigma_w)) @ sigma_b)
            + u @ jnp.diag(jnp.asarray(self.act_w)) @ u
        )

    def init(self):
        mu = jnp.array([2.0, 2.0, 0.0, 0.0])
        sigma = 1.0 * jnp.eye(self.belief_dim)
        return mu, sigma

    def reset_state(self) -> Array:
        return jnp.array([0.0, 4.0, 0.0, 0.0])


register("Car-TO-v0", Car)
