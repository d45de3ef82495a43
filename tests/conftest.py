"""Test harness config: CPU backend with 8 virtual devices, float64 numerics.

The platform is pinned through the config API before any backend is
initialized, so the suite runs on the CPU even where a GPU is attached.
Multi-device sharding tests run on the virtual CPU mesh (the standard
``xla_force_host_platform_device_count`` pattern); numerics tests use x64 to
compare against float64 NumPy oracles.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
