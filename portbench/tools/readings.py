"""The readings a cell's correctness limits are set from, at the cell's own
size, many seeds in one process (set-up is most of a run):

    python3 portbench/tools/readings.py --workload <cell> --seeds 1 2 3 [--seconds 3]
    python3 portbench/tools/readings.py --workload <cell> --seeds 1 2 3 --control
    python3 portbench/tools/readings.py --workload <cell> --seeds 1 2 3 --fault <name>

Without a flag: whole runs of the program (the window at the cell's load,
then the check). ``--control``: the reference one precision below the
configuration's put in the program's place (the driver's ``control``).
``--fault``: whole runs with one of the driver's ``FAULTS`` planted under
the timed path. Prints one JSON line a seed with each number beside its
limit. Needs the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import runner, spec  # noqa: E402
from portbench.harness.faults import Patches  # noqa: E402


def readings(root: Path, workload: str, seed: int, seconds: float, fault: str = "",
             control: bool = False, device: str = "cuda") -> dict:
    """The check's numbers of one seed, each beside its limit."""
    cell = spec.find_cell(root, workload)
    drv = spec.driver(root, cell.mix["driver"])
    limits = {k: v["limit"] for k, v in cell.limits["numbers"].items()}
    if control:
        numbers = drv.control(cell.config, cell.mix, seed, device)
        return {"numbers": numbers, "limits": limits,
                "correct": all(numbers[k] <= v for k, v in limits.items())}
    patches = Patches()
    try:
        if fault:
            drv.FAULTS[fault](patches.setattr)
        res = runner.run(root, workload, seed, seconds, False, time.perf_counter(), device)
    finally:
        patches.undo()
    return {"numbers": {k: c["value"] for k, c in res["check"].items()}, "limits": limits,
            "correct": res["correct"], "metrics": res["metrics"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--control", action="store_true")
    mode.add_argument("--fault", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    what = "control" if args.control else (args.fault or "program")
    for seed in args.seeds:
        got = readings(ROOT, args.workload, seed, args.seconds, args.fault, args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "what": what, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
