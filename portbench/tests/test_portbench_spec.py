"""The harness finds every configuration, mix, driver, metric reader and
limit by the names in BENCHMARK.json, picks up a cell, and a new kind of
traffic, added as files alone, and the file keeps to the contract's
shapes."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench.harness import runner, spec

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.find_cell(REPO, cell)
    assert c.config["name"] == c.config_name
    drv = spec.driver(REPO, c.mix["driver"])
    assert callable(drv.Driver) and callable(drv.control) and drv.FAULTS
    assert c.limits["numbers"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(REPO, metric))


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """A new configuration, mix, limits file and metric reader, and the
    entries naming them: nothing else changes."""
    root = tmp_path
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "portbench/configs/lstm_vgg16.json").read_text())
    conf["name"] = "lstm_vgg16_fused"
    conf["kernels"]["use_pallas_lstm"] = True
    (root / "portbench/configs/lstm_vgg16_fused.json").write_text(json.dumps(conf))
    mix = json.loads((REPO / "portbench/mixes/beam5_bulk.json").read_text())
    mix["batch"] = 64
    (root / "portbench/mixes/beam5_bulk64.json").write_text(json.dumps(mix))
    (root / "portbench/limits/lstm_vgg16_fused.beam5_bulk64.json").write_text(
        json.dumps({"numbers": {"score_gap": {"limit": 1.0}}}))
    (root / "portbench/metrics/calls.fused.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    bench["configs"].append({"name": "lstm_vgg16_fused", "source": "x",
                             "file": "portbench/configs/lstm_vgg16_fused.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "lstm_vgg16_fused.beam5_bulk64",
                               "config": "lstm_vgg16_fused", "traffic": "beam5_bulk64",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("lstm_vgg16_fused.beam5_bulk64")
    bench["per_layer"].append({"name": "calls.fused", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "clips_per_s",
                               "workloads": ["lstm_vgg16_fused.beam5_bulk64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(root, "lstm_vgg16_fused.beam5_bulk64")
    assert cell.config["kernels"]["use_pallas_lstm"] and cell.mix["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["calls.fused"]
    assert {m["name"] for m in cell.end_to_end} == {"clips_per_s", "setup_s"}

    class Window:
        calls = 7

    class Run:
        window = Window()

    assert spec.read_metrics(root, cell.per_layer, Run()) == {
        "calls.fused": {"value": 7.0, "unit": "calls"}}


def test_metrics_split_by_cell_share_their_stems_reader(tmp_path):
    (tmp_path / "portbench/metrics").mkdir(parents=True)
    (tmp_path / "portbench/metrics/a.b.py").write_text("def read(run):\n    return 1.0\n")
    (tmp_path / "portbench/metrics/a.b.c.py").write_text("def read(run):\n    return 2.0\n")
    assert spec.metric_reader(tmp_path, "a.b.bulk")(None) == 1.0
    assert spec.metric_reader(tmp_path, "a.b.c")(None) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.metric_reader(tmp_path, "z.bulk")


COUNTING = """
from portbench.harness.loop import Window, closed_loop


class Driver:
    def __init__(self, config, mix, seed, device, trace):
        self.mix, self.seed = mix, seed

    def window(self, seconds, trace):
        w = closed_loop(lambda i: self.mix["per_call"], seconds, self.mix["max_calls"], 0, 1,
                        trace)
        w.attempted = w.calls
        w.end_to_end = {"widgets_per_s": w.items / w.seconds}
        return w

    def free(self):
        pass

    def check(self):
        return {"widget_err": 0.0}


def control(config, mix, seed, device):
    return {"widget_err": 1.0}


FAULTS = {}
"""


def test_a_new_kind_of_traffic_added_as_files_alone_runs(tmp_path):
    """A new driver with an end-to-end metric of its own, its mix, a cell,
    its limits and a reader: files and entries only, and a whole run."""
    root = tmp_path
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "portbench/drivers/counting.py").write_text(COUNTING)
    (root / "portbench/mixes/widgets.json").write_text(
        json.dumps({"driver": "counting", "per_call": 3, "max_calls": 50}))
    (root / "portbench/limits/lstm_vgg16.widgets.json").write_text(
        json.dumps({"numbers": {"widget_err": {"limit": 0.5}}}))
    (root / "portbench/metrics/widgets.calls.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    bench["workloads"].append({"name": "lstm_vgg16.widgets", "config": "lstm_vgg16",
                               "traffic": "widgets", "chips": 1, "why": "x"})
    bench["end_to_end"].insert(0, {"name": "widgets_per_s", "unit": "widgets/s",
                                   "better": "higher", "bound": 0.05, "source": "host_clock",
                                   "workloads": ["lstm_vgg16.widgets"]})
    bench["per_layer"].append({"name": "widgets.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "widgets_per_s", "workloads": ["lstm_vgg16.widgets"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = runner.run(root, "lstm_vgg16.widgets", 3, 0.2, False, 0.0, device="cpu")
    assert res["correct"] and set(res["metrics"]) == {"widgets_per_s", "setup_s"}
    assert res["metrics"]["widgets_per_s"]["value"] > 0
    traced = runner.run(root, "lstm_vgg16.widgets", 3, 0.2, True, 0.0, device="cpu")
    assert set(traced["metrics"]) == {"widgets.calls"}
