"""Shared example-script helpers: platform selection and optional plotting.

Examples run on whatever device JAX selects (the GPU when one is attached, else
the CPU).  Pass ``--cpu`` to force the CPU backend (float64), ``--plot`` to show
matplotlib figures.  The persistent compile cache is placed by
``trajopt_jax.utils.compile_cache``.
"""

from __future__ import annotations

import argparse
import sys


def setup(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true", help="force CPU backend (f64)")
    parser.add_argument("--plot", action="store_true", help="show matplotlib plots")
    args, _ = parser.parse_known_args(argv)

    import jax

    from trajopt_jax.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    return args


def plot_trajectory(args, xs, us, sigmas=None):
    """State/action subplot strip like the reference solvers' ``plot`` methods."""
    if not args.plot:
        return
    import matplotlib.pyplot as plt
    import numpy as np

    xs, us = np.asarray(xs), np.asarray(us)
    dx, du = xs.shape[-1], us.shape[-1]
    plt.figure()
    for k in range(dx):
        plt.subplot(dx + du, 1, k + 1)
        plt.plot(xs[:, k], "-b")
        if sigmas is not None:
            sd = np.sqrt(np.asarray(sigmas)[:, k, k])
            t = np.arange(xs.shape[0])
            plt.fill_between(t, xs[:, k] - 2 * sd, xs[:, k] + 2 * sd, alpha=0.1)
    for k in range(du):
        plt.subplot(dx + du, 1, dx + k + 1)
        plt.plot(us[:, k], "-g")
    plt.show()
