"""The traced stretch: ``torch.profiler`` over a steady part of the window,
reduced from its Chrome trace to what the per-layer readers need.

Device activity is every kernel, memcpy and memset on the card. ``busy_s``
is the length of their union; an idle gap is named by what the host was
doing at its middle: the innermost of the benchmark's own spans (``pb.*``,
recorded around its calls into each layer) and the host op inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@contextmanager
def span(name: str):
    """A benchmark span around a call into a layer (a profiler annotation;
    free when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start (CUPTI's
    initialisation) takes seconds, which would otherwise fall in the window."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum().item()


class Stretch:
    """Profiles the calls made between ``start()`` and ``stop()``, which
    writes the trace; it is read and reduced (``summary``) when first asked
    for, after the window."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0
        self._summary: Optional[Dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        fd, self._path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self._path)
        self.prof = None

    @property
    def summary(self) -> Dict:
        if self._summary is None:
            try:
                with open(self._path, encoding="utf-8") as f:
                    events = json.load(f)["traceEvents"]
            finally:
                os.unlink(self._path)
            self._summary = summarize(events, self.wall_s)
        return self._summary


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarize(events: List[dict], wall_s: float) -> Dict:
    """Kernel time and count by name, HtoD copy time, busy seconds, and the
    idle gaps between device activity by what the host was doing."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    h2d_us = 0.0
    kernels = 0
    for e in dev:
        rec = by_name[e["name"]]
        rec[0] += 1
        rec[1] += float(e["dur"])
        if e["cat"] == "kernel":
            kernels += 1
        elif "HtoD" in e["name"]:
            h2d_us += float(e["dur"])
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    busy_us = sum(e - s for s, e in busy)

    spans = [e for e in host if e["name"].startswith("pb.")]
    ops = sorted((e for e in host if not e["name"].startswith("pb.")), key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in ops]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        gaps[_host_at((a + b) / 2, spans, ops, starts)] += (b - a) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": wall_s,
        "kernels": {k: (int(v[0]), v[1] / 1e6) for k, v in by_name.items()},
        "kernel_launches": kernels,
        "h2d_s": h2d_us / 1e6,
        "device_ops": sorted(([k, v[1] / 1e6] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
    }


def _host_at(t: float, spans: List[dict], ops: List[dict], starts: List[float],
             look: int = 400) -> str:
    """The innermost benchmark span covering ``t`` and the innermost host
    op among the ``look`` that started last before it, as ``span/op``."""
    def covering(events):
        return [e for e in events if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]

    inside = covering(spans)
    name = max(inside, key=lambda e: float(e["ts"]))["name"] if inside else "outside pb spans"
    i = bisect.bisect_right(starts, t)
    under = covering(ops[max(0, i - look):i])
    if under:
        name += "/" + max(under, key=lambda e: float(e["ts"]))["name"]
    return name[:120]


def kernel_time(summary: Dict, *substrings: str) -> Tuple[int, float]:
    """Launches and device seconds of the kernels whose names hold any of
    ``substrings``."""
    n, secs = 0, 0.0
    for name, (count, s) in summary.get("kernels", {}).items():
        if any(sub in name for sub in substrings):
            n, secs = n + count, secs + s
    return n, secs
