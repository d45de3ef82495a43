"""Profiling, device timing, and roofline accounting.

The reference has no tracing/profiling at all (SURVEY.md §5); this module provides:

* :func:`trace` — a context manager around ``jax.profiler`` writing a TensorBoard-
  loadable trace (per-kernel timelines, XLA op breakdown).
* :func:`seconds_per_call` — host clock around ``block_until_ready`` on a warmed
  executable: median and spread over repeated calls.
* :func:`backward_roofline` — achieved timesteps/s, memory bandwidth, and FLOP
  rate for the LQR backward pass against the peaks the caller names, so kernel
  work can be judged against the memory-bound ceiling rather than against other
  code.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/jax-trace"):`` — profile the enclosed device work."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def seconds_per_call(
    fn: Callable, args: tuple, repeats: int = 5
) -> tuple[float, tuple[float, float]]:
    """``(median, (min, max))`` seconds per ``fn(*args)``.

    ``fn`` should be jitted.  It is called once to warm up (not timed); each
    timed call is the host clock around the call and ``block_until_ready`` of
    its outputs, so the device work is inside the window.
    """
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return statistics.median(times), (min(times), max(times))


def backward_roofline(
    seconds_per_call: float,
    batch: int,
    T: int,
    dx: int,
    du: int,
    *,
    hbm_peak_gbs: float,
    flop_peak_tflops: float,
    dtype_bytes: int = 4,
) -> dict:
    """Achieved rates for one regularized iLQR backward pass vs the device
    peaks the caller names (memory GB/s and non-tensor-core FLOP/s — the
    kernel's arithmetic is elementwise).

    Bytes: every per-timestep block (Cxx, cx, Cuu, cu, Cxu, A, B) is streamed from
    device memory once and (K, kff) written once.  FLOPs: the ~10 small matmuls + Cholesky +
    two triangular solves per timestep, ≈ 2·(6·dx³-ish) — an estimate for ranking,
    not accounting.
    """
    in_entries = dx * dx * 2 + dx * du * 2 + du * du + dx + du
    out_entries = du * dx + du
    bytes_per_ts = (in_entries + out_entries) * dtype_bytes
    flops_per_ts = 2 * (4 * dx**3 + 4 * dx * dx * du + 2 * dx * du * du + du**3)

    ts_per_s = batch * T / seconds_per_call
    gbs = ts_per_s * bytes_per_ts / 1e9
    tflops = ts_per_s * flops_per_ts / 1e12
    return {
        "timesteps_per_s": ts_per_s,
        "achieved_GB_s": gbs,
        "hbm_fraction": gbs / hbm_peak_gbs,
        "achieved_TFLOP_s": tflops,
        "flop_fraction": tflops / flop_peak_tflops,
    }
