"""Fixtures of the benchmark's own tests (run with
``python -m pytest portbench/tests -q``).

``tiny_root`` copies the benchmark's data files into a temporary checkout
with every configuration shrunk (16-wide, V = 60, 6 frames, 5 tokens) and
the kernels' plain versions selected (``kernels.interpret``), so a whole
run of any cell drives the program on the CPU in seconds. Tests that need
the card take the ``card`` fixture, which skips where there is none.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = {"cnn_feature_dim": 24, "encoder_hidden_dim": 16, "decoder_hidden_dim": 16,
              "embedding_dim": 16, "attention_dim": 16, "vocab_size": 60,
              "video_sequence_length": 6, "max_sequence_length": 5, "transformer_num_heads": 2}
TINY_MIXES = {  # by the mix's driver
    "caption_closed": {"pool": 16, "batch": 8, "max_length": 5, "warm_batches": [8],
                       "trace_after_calls": 1, "trace_calls": 1, "check_clips": 8,
                       "max_calls": 6},
    "extract_closed": {"frames": 6, "height": 32, "width": 32, "batch": 4, "pool": 2,
                       "check_clips": 2, "max_calls": 4},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 and the CUDA kernels exist only there")


# Every (configuration, mix) pair the tests run, whether or not
# BENCHMARK.json measures it yet, with the number its check compares.
CAPTION = ("score_gap", "beam_gap")
TEST_CELLS = {"lstm_vgg16.beam5_bulk": CAPTION, "transformer_r50.beam5_bulk": CAPTION,
              "transformer_r50.extract": ("feature_rel_err",)}
TINY_LIMITS = {"score_gap": 5e-6, "beam_gap": 5e-6, "feature_rel_err": 1e-4}
SIBLINGS = {"transformer_r50.beam5_bulk": "lstm_vgg16.beam5_bulk"}


def make_tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark's data files with tiny sizes, and every
    cell of ``TEST_CELLS`` in its BENCHMARK.json."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("drivers", "metrics", "mixes", "limits"):
        shutil.copytree(REPO / "portbench" / sub, tmp / "portbench" / sub)
    (tmp / "portbench" / "configs").mkdir(parents=True)
    have = {w["name"] for w in bench["workloads"]}
    for name, numbers in TEST_CELLS.items():
        config, traffic = name.split(".")
        if name not in have:
            bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                       "chips": 1, "why": "tests"})
        limits = tmp / "portbench" / "limits" / f"{name}.json"
        limits.write_text(json.dumps({"numbers": {n: {"limit": TINY_LIMITS[n]} for n in numbers}}))
    if "transformer_r50" not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": "transformer_r50", "source": "tests",
                                 "file": "portbench/configs/transformer_r50.json",
                                 "reduced": [], "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        # A cell the file does not measure yet reports what its sibling does.
        for name, sibling in SIBLINGS.items():
            if sibling in m.get("workloads", ()) and name not in m["workloads"]:
                m["workloads"].append(name)
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf["model"].update(TINY_MODEL)
        conf["kernels"]["interpret"] = True  # the kernels' plain versions on the CPU
        conf["data"]["frames_per_video"] = TINY_MODEL["video_sequence_length"]
        (tmp / c["file"]).write_text(json.dumps(conf))
    for path in (tmp / "portbench" / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_MIXES[mix["driver"]])
        path.write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
