"""One run of one cell: set-up, the measured window, the metrics, the check.

The result is one JSON line, printed last on standard output; the numbers
the check compared, each beside its limit, are the last lines on standard
error and the line's last key.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

from . import spec
from .loop import Window
from .trace import warm_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "video_captioning_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's, compared whole."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


class Run:
    """What a per-layer reader reads: the cell, the window and its trace."""

    def __init__(self, cell: spec.Cell, window: Window):
        self.cell, self.window = cell, window
        self.config, self.mix = cell.config, cell.mix
        self.trace = window.traced.summary if window.traced is not None else {}


def end_to_end(cell: spec.Cell, w: Window, setup_s: float) -> Dict[str, dict]:
    """The cell's end-to-end metrics from what its driver produced."""
    values = {"setup_s": setup_s, **w.end_to_end}
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
    if missing:
        raise KeyError(f"driver {cell.mix['driver']!r} produces {sorted(values)}, "
                       f"not {missing}")
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Dict:
    cell = spec.find_cell(root, workload)
    driver = spec.driver(root, cell.mix["driver"]).Driver(cell.config, cell.mix, seed, device,
                                                           trace)
    if trace:
        warm_profiler()
    setup_s = time.perf_counter() - t0
    print(f"[portbench] {workload}: set-up {setup_s:.3f} s", file=sys.stderr)
    w = driver.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}: the benchmark must not import JAX, Flax "
                           "or the JAX package")
    if trace:
        metrics = spec.read_metrics(root, cell.per_layer, Run(cell, w))
    else:
        metrics = end_to_end(cell, w, setup_s)
    driver.free()
    gc.collect()
    numbers = driver.check()
    check = {name: {"value": numbers[name], "limit": lim["limit"]}
             for name, lim in cell.limits["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in check.values()) and w.failed == 0
    result = {"correct": correct, "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and w.traced is not None:
        result["device"]["busy_s"] = w.traced.summary["busy_s"]
        result["device"]["window_s"] = w.traced.summary["window_s"]
        result["breakdown"] = {"device_ops": w.traced.summary["device_ops"],
                               "idle_gaps": w.traced.summary["idle_gaps"]}
    result["check"] = check
    return result


def main(root: Path, args, t0: float) -> int:
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 3
    cell = spec.find_cell(root, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 3
    result = run(root, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    for name, c in result["check"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
