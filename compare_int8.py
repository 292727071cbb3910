"""Two trees' int8 1x1-conv kernels on one card: their outputs against their
own plain versions, their device times and their wrappers' host time, in
turns.

    python3 compare_int8.py --other DIR [--rounds 2]

DIR holds another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
Each tree runs in a process of its own, which imports that tree's
``video_captioning_tpu_torch`` and ``chip_smoke`` and builds its
``csrc/int8_matmul.cu``; the order is other, this, this, other
(``--rounds`` pairs), so drift on the card shows in both. Each process makes
its inputs with its tree's ``chip_smoke.int8_inputs`` (seed 60 at the odd
shapes, 62 at the forward's, as ``check_int8_matmul``) and:

* runs both kernels at every ``chip_smoke.INT8_EDGE_SHAPES`` entry (int8
  out at s_out 0.1 and 0.004, float32 out) and at the 17 shapes of a B = 32
  forward (``INT8_FORWARD_SHAPES``), each launch twice, and holds every
  output to the tree's own plain version bit for bit and the two launches
  to the same bits;
* times each forward shape by CUDA-graph replay
  (``compare_attention._graph_ms``: ten calls a graph, CUDA events, median
  of 5) beside ``torch._int_mm`` on the same operands, and sums each over
  the shape's launches (the 32 of a forward);
* times the wrapper's host side a call (200 calls on the host clock, at the
  last block's float32 conv3 and at stage 4's conv1).

Prints one JSON line per process, then the card's name and power limit and
a summary line: each tree's medians; whether every process saw the same
inputs and gave the same output bits; and the gate: this tree's 32-launch
sum below the other's, and no shape more than ``SHAPE_SLACK`` slower. Exits
1 if an output differs from the plain version or two launches differ.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

from compare_attention import _graph_ms, medians, run_in_turns, run_one

SHAPE_SLACK = 1.03
HOST_SHAPES = (("residual", 1568, 512, 2048, False), ("requant", 1568, 2048, 512, True))


def shape_key(name: str, M: int, K: int, N: int, int8_out: bool) -> str:
    return f"{name}_{M}x{K}x{N}_{'i8' if int8_out else 'f32'}"


def run_tree(tree: Path) -> dict:
    """Run one tree's int8 kernels in this process."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as smoke  # the tree's own (its package on sys.path first)
    from video_captioning_tpu_torch.ops import int8_matmul as im

    if Path(smoke.__file__).resolve().parent != tree or not Path(
            im.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{smoke.__file__} or {im.__file__} is not {tree}'s")
    res = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    digests, checks = [], []
    s_id = 0.03

    def calls(name, xq, wq, scale, bias, idq, so):
        if name == "requant":
            return (lambda: im.int8_matmul_requant(xq, wq, scale, bias, so, True),
                    lambda: im.int8_matmul_requant_reference(xq, wq, scale, bias, so, True))
        return (lambda: im.int8_matmul_residual_requant(xq, wq, scale, bias, idq, s_id, so),
                lambda: im.int8_matmul_residual_requant_reference(xq, wq, scale, bias, idq, s_id,
                                                                  so))

    def check(name, shape, fn, ref):
        got, again, want = fn(), fn(), ref()
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got, want)):
            raise AssertionError(f"int8 {name} {shape}: two launches differ or an output "
                                 f"differs from the plain version")
        digests.append(hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest())

    for M, K, N in smoke.INT8_EDGE_SHAPES:
        xq, wq, scale, bias, idq = smoke.int8_inputs("cuda", M, K, N, seed=60)
        checks.append(int(xq.sum().item()) + int(idq.sum().item()))
        for so in (0.1, 0.004, None):
            for name in ("requant", "residual"):
                check(name, (M, K, N, so), *calls(name, xq, wq, scale, bias, idq, so))
    kernel_sum = int_mm_sum = 0.0
    for name, M, K, N, int8_out, launches in smoke.INT8_FORWARD_SHAPES:
        xq, wq, scale, bias, idq = smoke.int8_inputs("cuda", M, K, N, seed=62)
        checks.append(int(xq.sum().item()) + int(idq.sum().item()) + float(scale.sum().item()))
        so = 0.1 if int8_out else None
        fn, ref = calls(name, xq, wq, scale, bias, idq, so)
        check(name, (M, K, N, so), fn, ref)
        key = shape_key(name, M, K, N, int8_out)
        res[f"{key}_ms"] = ms = _graph_ms(torch, fn)
        res[f"{key}_int_mm_ms"] = lib = _graph_ms(torch, lambda: torch._int_mm(xq, wq.t()))
        kernel_sum += launches * ms
        int_mm_sum += launches * lib
        if (name, M, K, N, int8_out) in HOST_SHAPES:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res[f"{key}_host_us"] = (t1 - t0) / 200 * 1e6
        del xq, wq, scale, bias, idq
    res["forward32_ms"] = kernel_sum
    res["forward32_int_mm_ms"] = int_mm_sum
    res["inputs_checksum"] = sum(checks)
    res["outputs_digest"] = hashlib.sha256("".join(digests).encode()).hexdigest()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1, help="(other, this, this, other) pairs")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one tree, this process
    args = ap.parse_args(argv)
    if args.run is not None:
        return run_one("compare_int8", run_tree, args.run.resolve())
    if args.other is None:
        ap.error("--other is required")
    card, runs, _ = run_in_turns(Path(__file__), args.other, args.rounds)
    med = medians(runs, ("_ms", "_us"))
    this, other = med["this"], med["other"]
    shapes = [k for k in this if k.endswith("_ms") and not k.endswith("_int_mm_ms")
              and not k.startswith("forward32")]
    slower = {k: this[k] / other[k] for k in shapes if this[k] > SHAPE_SLACK * other[k]}
    gate = {"forward32_faster": this["forward32_ms"] < other["forward32_ms"],
            "no_shape_slower_than_slack": not slower, "slower": slower}
    same_inputs = len({r["inputs_checksum"] for who in runs for r in runs[who]}) == 1
    same_bits = len({r["outputs_digest"] for who in runs for r in runs[who]}) == 1
    print(card)
    print(json.dumps({"card": card, "same_inputs": same_inputs, "same_bits": same_bits,
                      "gate": gate, "median": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
