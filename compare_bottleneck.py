"""Two trees' ``fused_bottleneck`` kernels on one card: their errors against
their own plain versions and their device times, in turns.

    python3 compare_bottleneck.py --other DIR [--rounds 2]

DIR holds another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
Each tree runs in a process of its own, which imports that tree's
``video_captioning_tpu_torch`` and ``chip_smoke`` and builds its
``csrc/fused_bottleneck.cu``; the order is other, this, this, other
(``--rounds`` pairs), so drift on the card shows in both. Each process
makes its inputs with its tree's ``chip_smoke.bottleneck_inputs`` (the
same seeds as ``check_fused_bottleneck``: 40 at the edge shapes, 41 +
stage at the stages; the summary says whether every process saw the same
inputs) and, in float32 and bfloat16:

* runs every ``chip_smoke.BOTTLENECK_EDGE_SHAPES`` entry and the four
  ResNet50 stages' identity blocks at B = 32, each launch twice, and holds
  the output to the tree's own plain version within ``CNN_RTOL`` of the
  largest |output| and the two launches to the same bits;
* times each stage's launch by CUDA-graph replay
  (``compare_attention._graph_ms``: ten calls a graph, CUDA events, median
  of 5), and cuDNN's unfused block (three convs with their biases, the
  residual add and the ReLUs, TF32 off) the same way, and sums each over
  the 12 identity blocks of a B = 32 forward (2 + 3 + 5 + 2 a stage).

Prints one JSON line per process, then the card's name and power limit and
a summary line: each tree's medians and, for each dtype, whether this
tree's 12-block sum is below the other's and no stage is more than
``STAGE_SLACK`` slower (the gate a redesign of either form must pass).
Exits 1 if an output is out of tolerance or two launches differ. Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from compare_attention import _graph_ms, medians, run_in_turns, run_one

STAGE_SLACK = 1.03
DTYPES = ("float32", "bfloat16")


def run_tree(tree: Path) -> dict:
    """Run one tree's fused_bottleneck in this process."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as smoke  # the tree's own (its package on sys.path first)
    from video_captioning_tpu_torch.models.backbones.resnet import _bottleneck_folded
    from video_captioning_tpu_torch.ops import bottleneck

    if Path(smoke.__file__).resolve().parent != tree or not Path(
            bottleneck.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{smoke.__file__} or {bottleneck.__file__} is not {tree}'s")
    torch.backends.cudnn.allow_tf32 = False
    res = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    checks = []

    def check(x, ws, tag):
        got, again = bottleneck.fused_bottleneck(x, *ws), bottleneck.fused_bottleneck(x, *ws)
        want = bottleneck.fused_bottleneck_reference(x, *ws)
        err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        same = bool(smoke.same_bits((got,), (again,)))
        if not (err <= smoke.CNN_RTOL[x.dtype] and same):
            raise AssertionError(f"fused_bottleneck {tag}: error {err:.3g} over the largest "
                                 f"|output| (tol {smoke.CNN_RTOL[x.dtype]}), two launches the "
                                 f"same bits: {same}")
        checks.append(x.float().sum().item())
        return err

    for dt in DTYPES:
        dtype = getattr(torch, dt)
        res[f"{dt}_edge_max_err"] = max(
            check(*smoke.bottleneck_inputs("cuda", *s[:3], *s[3:], dtype, seed=40), f"{s} {dt}")
            for s in smoke.BOTTLENECK_EDGE_SHAPES)
        kernel_sum = cudnn_sum = 0.0
        for stage, (H, C, Cm) in enumerate(smoke.RESNET_STAGES, start=1):
            x, ws = smoke.bottleneck_inputs("cuda", 32, H, H, C, Cm, dtype, seed=41 + stage)
            res[f"{dt}_stage{stage}_err"] = check(x, ws, f"stage {stage} {dt}")
            ms = _graph_ms(torch, lambda: bottleneck.fused_bottleneck(x, *ws))
            block = {"conv1": {"w": ws[0], "b": ws[1]}, "conv2": {"kernel": ws[2], "b": ws[3]},
                     "conv3": {"w": ws[4], "b": ws[5]}}
            xn = x.permute(0, 3, 1, 2)
            lib = _graph_ms(torch, lambda: _bottleneck_folded(block, xn, 1, False))
            res[f"{dt}_stage{stage}_ms"] = ms
            res[f"{dt}_stage{stage}_cudnn_ms"] = lib
            n = smoke.RESNET_IDENTITY_BLOCKS[stage - 1]
            kernel_sum += n * ms
            cudnn_sum += n * lib
        res[f"{dt}_forward12_ms"] = kernel_sum
        res[f"{dt}_forward12_cudnn_ms"] = cudnn_sum
    res["inputs_checksum"] = sum(checks)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1, help="(other, this, this, other) pairs")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one tree, this process
    args = ap.parse_args(argv)
    if args.run is not None:
        return run_one("compare_bottleneck", run_tree, args.run.resolve())
    if args.other is None:
        ap.error("--other is required")
    card, runs, _ = run_in_turns(Path(__file__), args.other, args.rounds)
    med = medians(runs, ("_ms", "_err"))
    gate = {}
    for dt in DTYPES:
        this, other = med["this"], med["other"]
        stages = [this[f"{dt}_stage{s}_ms"] <= STAGE_SLACK * other[f"{dt}_stage{s}_ms"]
                  for s in range(1, 5)]
        gate[dt] = {"forward12_faster": this[f"{dt}_forward12_ms"] < other[f"{dt}_forward12_ms"],
                    "no_stage_slower_than_slack": all(stages)}
    same_inputs = len({r["inputs_checksum"] for who in runs for r in runs[who]}) == 1
    print(card)
    print(json.dumps({"card": card, "same_inputs": same_inputs, "gate": gate, "median": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
