"""Two trees' encoder recurrence kernels on one card: the same bits, and
their device times in turns.

    python3 compare_lstm.py --other DIR [--rounds 1]

DIR holds another checkout of this repository (for example an earlier
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
Each tree, in a process of its own that imports that tree's
``video_captioning_tpu_torch`` and builds its kernels, runs the main
path's recurrences on the same seeded inputs: ``lstm_seq`` at
(80, 2, 128, 2048) with float32 and bfloat16 xproj, and ``lstm_seq_train``'s
forward and backward at (80, 2, 32, 2048), float32, ragged lengths (the
narrow forms, H = 512); then the wide forms (H = 1024): ``lstm_seq`` at
(80, 2, 128, 4096) with float32 and bfloat16 xproj, the training forward
at (80, 2, 32, 4096), and the training backward there with float32 and
bfloat16 xproj (on the plain forward's residuals, random cotangents). Every
output is held against the tree's own plain version; the narrow forms'
outputs are written to a temporary directory and compared bit for bit with
the first run's (the wide forms' bits may differ between designs: their
errors are reported instead: the largest absolute error, or for a backward
the largest error over the output's largest value). The launches
are timed by CUDA-graph replay (``compare_attention._graph_ms``: three
calls a graph, CUDA events, median of 5). The order is other, this, this,
other (``--rounds`` pairs), so drift on the card shows in both. Prints one
JSON line per process, then the card's name and power limit and a summary
line (``same_bits`` and each tree's median times). Exits 1 if the bits
differ. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from compare_attention import _graph_ms, medians, run_in_turns, run_one, same_bits_as_first


def run_tree(tree: Path, out: Path) -> dict:
    """Run one tree's recurrence kernels in this process; save their
    outputs to ``out``."""
    sys.path.insert(0, str(tree))
    import importlib

    import torch

    seq = importlib.import_module("video_captioning_tpu_torch.ops.lstm_seq")
    train = importlib.import_module("video_captioning_tpu_torch.ops.lstm_seq_train")

    def inputs(dtype, B, T=80, ND=2, H=512, seed=1):
        g = torch.Generator(device="cpu").manual_seed(seed)
        xproj = (torch.randn((T, ND, B, 4 * H), generator=g) * 0.5).to(dtype)
        w = ((torch.rand((ND, H, 4 * H), generator=g) * 2 - 1) / H ** 0.5).to(torch.bfloat16)
        lengths = torch.randint(1, T + 1, (B,), generator=g)
        lengths[0] = T
        mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.float32)
        return xproj.cuda(), w.cuda(), mask.cuda()

    def err(got, want):
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    res = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    outputs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, w, m = inputs(dtype, 128)
        o, (h, c) = seq.lstm_seq(x, w, m)
        ro, (rh, rc) = seq.lstm_seq_reference(x, w, m)
        outputs[f"lstm_seq_{tag}"] = [o.cpu(), h.cpu(), c.cpu()]
        res[f"lstm_seq_{tag}_max_abs_err"] = err((o, h, c), (ro, rh, rc))
        res[f"lstm_seq_{tag}_ms"] = _graph_ms(torch, lambda: seq.lstm_seq(x, w, m), calls=3)
    x, w, m = inputs(torch.float32, 32)
    fwd = train.lstm_seq_train_fwd(x, w, m)
    res["train_fwd_max_abs_err"] = err(fwd, train.lstm_seq_train_fwd_reference(x, w, m))
    g = torch.Generator(device="cpu").manual_seed(2)
    douts = torch.randn(tuple(fwd[0].shape), generator=g).cuda()
    dh, dc = (torch.randn(tuple(fwd[1].shape), generator=g).cuda() for _ in range(2))
    bwd = train.lstm_seq_train_bwd(*fwd[3:], w, m, douts, dh, dc)
    want = train.lstm_seq_train_bwd_reference(*fwd[3:], w, m, douts, dh, dc)
    res["train_bwd_max_rel_err"] = max(((a - b).abs().max() / b.abs().max()).item()
                                       for a, b in zip(bwd, want))
    outputs["train_fwd"] = [t.cpu() for t in fwd]
    outputs["train_bwd"] = [t.cpu() for t in bwd]
    res["train_fwd_ms"] = _graph_ms(torch, lambda: train.lstm_seq_train_fwd(x, w, m),
                                    calls=3)
    res["train_bwd_ms"] = _graph_ms(
        torch, lambda: train.lstm_seq_train_bwd(*fwd[3:], w, m, douts, dh, dc), calls=3)
    torch.save(outputs, out)
    # The wide forms at H = 1024.
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, w, m = inputs(dtype, 128, H=1024)
        res[f"wide_lstm_seq_{tag}_max_abs_err"] = err(
            (lambda o: (o[0], *o[1]))(seq.lstm_seq(x, w, m)),
            (lambda o: (o[0], *o[1]))(seq.lstm_seq_reference(x, w, m)))
        res[f"wide_lstm_seq_{tag}_ms"] = _graph_ms(torch, lambda: seq.lstm_seq(x, w, m), calls=3)
    x, w, m = inputs(torch.float32, 32, H=1024)
    res["wide_train_fwd_max_abs_err"] = err(train.lstm_seq_train_fwd(x, w, m),
                                            train.lstm_seq_train_fwd_reference(x, w, m))
    res["wide_train_fwd_ms"] = _graph_ms(torch, lambda: train.lstm_seq_train_fwd(x, w, m),
                                         calls=3)
    # The wide backward at (80, 2, 32, 4096), float32 and bfloat16 xproj, on
    # the plain forward's residuals, with random cotangents in xproj's type.
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, w, m = inputs(dtype, 32, H=1024)
        fwd = train.lstm_seq_train_fwd_reference(x, w, m)
        g = torch.Generator(device="cpu").manual_seed(2)
        douts = torch.randn(tuple(fwd[0].shape), generator=g).to("cuda", dtype)
        dh, dc = (torch.randn(tuple(fwd[1].shape), generator=g).cuda() for _ in range(2))
        bwd = train.lstm_seq_train_bwd(*fwd[3:], w, m, douts, dh, dc)
        want = train.lstm_seq_train_bwd_reference(*fwd[3:], w, m, douts, dh, dc)
        res[f"wide_train_bwd_{tag}_max_rel_err"] = max(
            ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for a, b in zip(bwd, want))
        res[f"wide_train_bwd_{tag}_ms"] = _graph_ms(
            torch, lambda: train.lstm_seq_train_bwd(*fwd[3:], w, m, douts, dh, dc), calls=3)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1, help="(other, this, this, other) pairs")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one tree, this process
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:
        return run_one("compare_lstm", run_tree, args.run.resolve(), args.out)
    if args.other is None:
        ap.error("--other is required")
    with tempfile.TemporaryDirectory() as tmp:
        card, runs, files = run_in_turns(Path(__file__), args.other, args.rounds, Path(tmp))
        same = same_bits_as_first(files)
    print(card)
    print(json.dumps({"card": card, "same_bits": same, "median_ms": medians(runs)}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
