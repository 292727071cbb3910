"""Whole runs at a tiny size on the CPU (the harness's look for a card
skipped): a sound program comes out correct, and the same run with the timed
path broken underneath comes out not correct, once for each fault the cell
can have (its driver's ``FAULTS``; one card, so no exchange between cards to
leave out)."""

from __future__ import annotations

import time

import numpy as np
import pytest

from portbench.harness import runner, spec

CAPTION_CELLS = ("lstm_vgg16.beam5_bulk", "transformer_r50.beam5_bulk")


def run(root, cell, seed=2 ** 31 + 5, seconds=1.0):
    return runner.run(root, cell, seed, seconds, False, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", CAPTION_CELLS + ("transformer_r50.extract",))
def test_sound_run_is_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"


def _faults(root, cell):
    return spec.driver(root, spec.find_cell(root, cell).mix["driver"]).FAULTS


@pytest.mark.parametrize("cell", CAPTION_CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered",
                                   "topk_ranks_shifted", "worst_hypothesis_served"])
def test_broken_caption_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _faults(tiny_root, cell)[fault](monkeypatch.setattr)
    assert not run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("cell", CAPTION_CELLS)
@pytest.mark.parametrize("fault", ["topk_ranks_shifted", "worst_hypothesis_served"])
def test_a_wrong_selection_is_seen_by_the_beam_gap_alone(tiny_root, monkeypatch, cell, fault):
    """Tokens and scores that agree with each other but are not the beam's
    best: the score check passes them, the beam check does not."""
    _faults(tiny_root, cell)[fault](monkeypatch.setattr)
    check = run(tiny_root, cell)["check"]
    assert check["score_gap"]["value"] <= check["score_gap"]["limit"]
    assert check["beam_gap"]["value"] > check["beam_gap"]["limit"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_broken_extraction_is_not_correct(tiny_root, monkeypatch, fault):
    _faults(tiny_root, "transformer_r50.extract")[fault](monkeypatch.setattr)
    res = run(tiny_root, "transformer_r50.extract")
    assert not res["correct"] and np.isfinite(res["check"]["feature_rel_err"]["value"])


@pytest.mark.parametrize("cell", ["lstm_vgg16.beam5_bulk", "transformer_r50.extract"])
def test_traced_run_reads_what_it_finds(tiny_root, cell):
    """A traced run on the CPU: the readers of counters and host clocks
    read, those of device time find nothing and are left out."""
    res = runner.run(tiny_root, cell, 11, 2.0, True, time.perf_counter(), device="cpu")
    assert res["correct"]
    names = set(res["metrics"])
    assert not any(n.endswith("_roofline") or n.startswith("device.idle") for n in names)
    assert any(n.startswith("mfu.") for n in names)
