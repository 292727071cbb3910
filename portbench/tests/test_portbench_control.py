"""The control (the reference in TF32 put in the program's place) fails a
limit of each cell, at the cell's own size, on three seeds. Card only."""

from __future__ import annotations

import json

import pytest

from portbench.tools.readings import readings

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, cell):
    for seed in (101, 202, 303):
        got = readings(REPO, cell, seed, 0.0, control=True)
        assert not got["correct"], (seed, got)
