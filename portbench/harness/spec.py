"""Where the benchmark's files are, found by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own, and so does each driver, each per-layer
metric's reader and each cell's correctness limits:

* ``portbench/configs/<config>.json`` (the ``file`` of the configuration),
* ``portbench/mixes/<traffic>.json``: the mix's numbers, and in ``driver``
  the name of the loop that sends them,
* ``portbench/drivers/<driver>.py``: the loop (defines ``Driver`` and
  ``control``); it names the end-to-end values it produces,
* ``portbench/metrics/<metric>.py`` (defines ``read(run)``); a metric split
  by cell (``device.idle.bulk``) may share the reader of its stem
  (``device.idle.py``),
* ``portbench/limits/<cell>.json``.

Adding a cell, a configuration, a mix, a driver or a metric is adding files
and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict        # the configuration's file
    mix: dict           # the traffic mix's file
    limits: dict        # the cell's correctness limits
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` is every cell's."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    return Cell(
        name=name,
        config_name=w["config"],
        traffic=w["traffic"],
        chips=int(w["chips"]),
        config=_read_json(root / conf["file"]),
        mix=_read_json(root / "portbench" / "mixes" / f"{w['traffic']}.json"),
        limits=_read_json(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def _load(path: Path, prefix: str) -> ModuleType:
    """A module loaded by path (names hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{prefix}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(root: Path, name: str) -> ModuleType:
    """``portbench/drivers/<name>.py``: ``Driver(config, mix, seed, device,
    trace)`` with ``window``, ``free`` and ``check``, and ``control``."""
    return _load(Path(root) / "portbench" / "drivers" / f"{name}.py", "driver")


def metric_reader(root: Path, name: str) -> Callable:
    """``read`` of ``portbench/metrics/<name>.py`` or, where there is none,
    of the longest stem of the name that has one (``device.idle.bulk`` ->
    ``device.idle.py``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = Path(root) / "portbench" / "metrics" / f"{'.'.join(parts[:n])}.py"
        if path.is_file():
            return _load(path, "metric").read
    raise FileNotFoundError(f"no reader for metric {name!r} in portbench/metrics/")


def read_metrics(root: Path, metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric's reader on the run; a reader that finds nothing to read
    returns None and the metric is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
