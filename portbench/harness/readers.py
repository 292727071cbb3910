"""Arithmetic the per-layer readers share: idle share, rooflines and the
shapes a mix sends to the kernels."""

from __future__ import annotations

from typing import Optional

from portbench.counts import kernels as kc
from portbench.counts.kernels import PEAKS

from .trace import kernel_time


def bucket(n: int) -> int:
    """The predictor's batch bucket: the next power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def idle_percent(run) -> Optional[float]:
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_percent(run, counter: str, per_launch, *kernel_names: str) -> Optional[float]:
    """The least time for the launches the program counted in the traced
    stretch (``per_launch`` gives one launch's operations and bytes) over
    the device time of the kernels named; None where either is missing."""
    launches = run.window.launches.get(counter, 0)
    _, seconds = kernel_time(run.trace, *kernel_names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * kc.bound_s(*per_launch) / seconds


def mfu_percent(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAKS["flops_per_s"]
