"""Two trees' ``matmul_bias_act`` kernels on one card: their errors against
their own plain versions and their device times, in turns.

    python3 compare_conv1x1.py --other DIR [--rounds 2]

DIR holds another checkout of this repository (for example an earlier
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
Each tree, in a process of its own that imports that tree's
``video_captioning_tpu_torch`` and builds its ``csrc/conv1x1.cu``, runs
``matmul_bias_act`` on the same seeded inputs at stage 1's conv3 shape
(M = 100352, K = 64, N = 256) in float32 with the residual and ReLU, with
ReLU alone, and with the residual and no ReLU, and in bfloat16 with the
residual and ReLU; each output is held against the tree's own plain version
(the largest error over the largest |output|; the two designs need not
share bits), and each launch is timed by CUDA-graph replay
(``compare_attention._graph_ms``: ten calls a graph, CUDA events, median
of 5). Each process also times the F.linear + add + ReLU composite the same
way. The order is other, this, this, other (``--rounds`` pairs), so drift
on the card shows in both. Prints one JSON line per process, then the
card's name and power limit and a summary line with each tree's median
times. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from compare_attention import _graph_ms, medians, run_in_turns, run_one

SHAPE = (100352, 64, 256)


def run_tree(tree: Path) -> dict:
    """Run one tree's matmul_bias_act in this process."""
    sys.path.insert(0, str(tree))
    import importlib

    import torch

    mod = importlib.import_module("video_captioning_tpu_torch.ops.conv1x1")
    torch.backends.cuda.matmul.allow_tf32 = False
    M, K, N = SHAPE
    g = torch.Generator(device="cpu").manual_seed(50)
    x, w, b, r = (torch.randn((M, K), generator=g), torch.randn((N, K), generator=g) / K ** 0.5,
                  torch.randn(N, generator=g) * 0.1, torch.randn((M, N), generator=g))
    res = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    for tag, dtype, with_r, relu in (("f32_residual_relu", torch.float32, True, True),
                                     ("f32_relu", torch.float32, False, True),
                                     ("f32_residual", torch.float32, True, False),
                                     ("bf16_residual_relu", torch.bfloat16, True, True)):
        xs, ws, bs, rs = (t.to(dtype).cuda() for t in (x, w, b, r))
        rs = rs if with_r else None
        got = mod.matmul_bias_act(xs, ws, bs, rs, relu=relu)
        want = mod.matmul_bias_act_reference(xs, ws, bs, rs, relu=relu)
        res[f"{tag}_max_rel_err"] = ((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()).item()
        res[f"{tag}_ms"] = _graph_ms(torch, lambda: mod.matmul_bias_act(xs, ws, bs, rs,
                                                                        relu=relu))
    xs, ws, bs, rs = (t.cuda() for t in (x, w, b, r))
    res["composite_f32_residual_relu_ms"] = _graph_ms(
        torch, lambda: torch.relu(torch.nn.functional.linear(xs, ws, bs) + rs))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1, help="(other, this, this, other) pairs")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one tree, this process
    args = ap.parse_args(argv)
    if args.run is not None:
        return run_one("compare_conv1x1", run_tree, args.run.resolve())
    if args.other is None:
        ap.error("--other is required")
    card, runs, _ = run_in_turns(Path(__file__), args.other, args.rounds)
    print(card)
    print(json.dumps({"card": card, "median": medians(runs, ("_ms", "_err"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
