"""A trajectory-optimization framework in JAX for GPUs.

Built from scratch in JAX/XLA/Pallas with the capability surface of the
``hanyas/trajopt`` reference toolbox (see SURVEY.md): Riccati LQR, iLQR, eLQR,
belief-space iLQR, and KL-constrained Guided Policy Search in standard and
distributionally-robust flavors, over a suite of differentiable benchmark
environments.
"""

import jax as _jax

# Trajectory optimization recurses tiny ill-conditioned matrices hundreds of
# steps.  At the default precision an f32 matrix product on the GPU may run in
# TF32 (about three decimal digits), which corrupts the value recursions and
# lets EKF covariances lose definiteness.  Full-f32 matmuls are mandatory for
# correctness here and cost nothing at these shapes; users can override after
# import.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import envs  # noqa: F401  (registers all environments)
from .envs.base import make, registered  # noqa: F401

__version__ = "0.1.0"
