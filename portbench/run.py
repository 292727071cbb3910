"""Benchmark of video_captioning_tpu_torch: one cell of BENCHMARK.json a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the first CUDA card of the machine it is started on and exits
non-zero, printing no result, where there is none. The last line of
standard output is the result's JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel caches of fixed paths inside the checkout (the program's nvcc
# builds already live in its package's _build/).
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from portbench.harness import runner

    sys.exit(runner.main(ROOT, parse(), T0))
