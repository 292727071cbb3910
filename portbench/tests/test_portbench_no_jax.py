"""Nothing the benchmark imports is JAX, Flax or the JAX package, compared
by whole top-level module names (the port's name only begins with the JAX
package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import REPO

PROBE = r"""
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
spec = importlib.util.spec_from_file_location("portbench_run", root / "portbench/run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
import portbench.harness.runner, portbench.harness.captioning, portbench.harness.readers
import portbench.harness.faults
import portbench.reference.captioner, portbench.reference.resnet50
import portbench.counts.kernels, portbench.counts.models
import portbench.tools.readings
from portbench.harness import spec as s
for p in (root / "portbench/metrics").glob("*.py"):
    s.metric_reader(root, p.stem)
for p in (root / "portbench/drivers").glob("*.py"):
    s.driver(root, p.stem)
for p in (root / "portbench/configs").glob("*.json"):
    json.loads(p.read_text())
# What a run imports of the port, set up at a tiny size.
import video_captioning_tpu_torch.inference.predictor
import video_captioning_tpu_torch.models.backbones
print(json.dumps(sorted(sys.modules)))
"""


def test_nothing_imported_is_jax():
    out = subprocess.run([sys.executable, "-c", PROBE, str(REPO)], capture_output=True,
                         text=True, check=True, timeout=300)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {"jax", "jaxlib", "flax", "video_captioning_tpu"}, sorted(tops)
    assert "video_captioning_tpu_torch" in tops and "portbench" in tops


def test_the_runs_own_check_compares_whole_names(monkeypatch):
    from portbench.harness import runner

    monkeypatch.setitem(sys.modules, "video_captioning_tpu_torch_probe", object())
    assert "video_captioning_tpu_torch_probe" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runner.forbidden_modules() == ["jax.numpy"]
