"""Two trees' encoder recurrence kernels on one card: the same bits, and
their device times in turns.

    python3 compare_lstm.py --other DIR [--rounds 1]

DIR holds another checkout of this repository (for example an earlier
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
Each tree, in a process of its own that imports that tree's
``video_captioning_tpu_torch`` and builds its kernels, runs the main
path's recurrences on the same seeded inputs: ``lstm_seq`` at
(80, 2, 128, 2048) with float32 and bfloat16 xproj and at (80, 2, 32, 2048)
with float32, and ``lstm_seq_train``'s forward and backward at
(80, 2, 32, 2048) and (80, 2, 128, 2048), float32, ragged lengths (the
narrow forms, H = 512); then the wide forms (H = 1024): ``lstm_seq`` at
(80, 2, 128, 4096) with float32 and bfloat16 xproj, the training forward
at (80, 2, 32, 4096), and the training backward there with float32 and
bfloat16 xproj (on the plain forward's residuals, random cotangents). Every
output is held against the tree's own plain version; the narrow forms'
outputs but dW_hh are written to a temporary directory and compared bit
for bit with the first run's, and the narrow dW_hh by its largest error
over its largest value against the first run's (``dw_rel_err``: a design
may sum its reduction in another order). The wide forms' bits may differ
between designs too: their errors against the plain version are reported
instead (the largest absolute error, or for a backward the largest error
over the output's largest value). The launches are timed by CUDA-graph
replay (``compare_attention._graph_ms``: three calls a graph, CUDA events,
median of 5), and a backward's dW_hh launch alone by the profiler
(``dw_device_ms``, the kernels whose names hold ``lstm_seq_dw``, as
``chip_smoke.check_lstm_train`` reads them). The order is other, this,
this, other (``--rounds`` pairs), so drift on the card shows in both.
Prints one JSON line per process, then the card's name and power limit
and a summary line (``same_bits``, ``dw_rel_err`` and each tree's median
times). Exits 1 if the bits differ or dW_hh lies more than ``DW_RTOL``
from the first run's. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from compare_attention import _graph_ms, medians, run_in_turns, run_one, same_bits_as_first

# How far one design's dW_hh may lie from another's, relative to its
# largest value. Two designs that take the same bf16 products with float32
# sums differ only in the sums' order: the mma.sync design with split
# partials and the wgmma design with cluster parts lay 1.2e-6 (B = 32) and
# 4.8e-6 (B = 128) apart (NVIDIA H100 80GB HBM3, 700.00 W), while a lost
# stage of rows (64 of the 10112 at B = 128) moves it by orders of
# magnitude more.
DW_RTOL = 1e-4


def _dw_device_ms(torch, fn, calls: int = 5) -> float:
    """Device time a call of the kernels whose names hold ``lstm_seq_dw``
    (torch.profiler, after a warm-up), as ``chip_smoke.device_ms`` reads it
    (a tree's process imports that tree's package, so not chip_smoke)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == cuda and "lstm_seq_dw" in e.key) / calls


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
    o, (h, c) = seq.lstm_seq(x, w, m)
    outputs["lstm_seq_f32_b32"] = [o.cpu(), h.cpu(), c.cpu()]
    res["lstm_seq_f32_b32_max_abs_err"] = err((o, h, c), (lambda r: (r[0], *r[1]))(
        seq.lstm_seq_reference(x, w, m)))
    res["lstm_seq_f32_b32_ms"] = _graph_ms(torch, lambda: seq.lstm_seq(x, w, m), calls=3)
    dws = {}
    for B, tag in ((32, ""), (128, "_b128")):
        x, w, m = inputs(torch.float32, B)
        fwd = train.lstm_seq_train_fwd(x, w, m)
        res[f"train_fwd{tag}_max_abs_err"] = err(fwd, train.lstm_seq_train_fwd_reference(x, w, m))
        g = torch.Generator(device="cpu").manual_seed(2)
        douts = torch.randn(tuple(fwd[0].shape), generator=g).cuda()
        dh, dc = (torch.randn(tuple(fwd[1].shape), generator=g).cuda() for _ in range(2))

        def bwd_call(fwd=fwd, w=w, m=m, douts=douts, dh=dh, dc=dc):
            return train.lstm_seq_train_bwd(*fwd[3:], w, m, douts, dh, dc)

        bwd = bwd_call()
        want = train.lstm_seq_train_bwd_reference(*fwd[3:], w, m, douts, dh, dc)
        res[f"train_bwd{tag}_max_rel_err"] = max(((a - b).abs().max() / b.abs().max()).item()
                                                 for a, b in zip(bwd, want))
        outputs[f"train_fwd{tag}"] = [t.cpu() for t in fwd]
        outputs[f"train_bwd{tag}_dxproj"] = [bwd[0].cpu()]
        dws[f"train_bwd{tag}_dw"] = bwd[1].cpu()
        res[f"train_fwd{tag}_ms"] = _graph_ms(
            torch, lambda x=x, w=w, m=m: train.lstm_seq_train_fwd(x, w, m), calls=3)
        res[f"train_bwd{tag}_ms"] = _graph_ms(torch, bwd_call, calls=3)
        res[f"train_bwd{tag}_dw_device_ms"] = _dw_device_ms(torch, bwd_call)
    torch.save({"bits": outputs, "dw": dws}, out)
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
        res[f"wide_train_bwd_{tag}_dw_device_ms"] = _dw_device_ms(
            torch, lambda: train.lstm_seq_train_bwd(*fwd[3:], w, m, douts, dh, dc))
    return res


def dw_errors(files: list) -> dict:
    """For each saved dW_hh: the largest error over its largest value of
    any run against the first run's."""
    first = torch.load(files[0])["dw"]
    worst = {k: 0.0 for k in first}
    for f in files[1:]:
        for k, v in torch.load(f)["dw"].items():
            rel = ((v - first[k]).abs().max() / first[k].abs().max()).item()
            worst[k] = max(worst[k], rel)
    return worst


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
        bits = []
        for f in files:  # the outputs compared bit for bit, in a file of their own
            bits.append(f.with_suffix(".bits.pt"))
            torch.save(torch.load(f)["bits"], bits[-1])
        same = same_bits_as_first(bits)
        dw_err = dw_errors(files)
    print(card)
    print(json.dumps({"card": card, "same_bits": same, "dw_rel_err": dw_err,
                      "median_ms": medians(runs)}))
    return 0 if all(same.values()) and max(dw_err.values()) <= DW_RTOL else 1


if __name__ == "__main__":
    sys.exit(main())
