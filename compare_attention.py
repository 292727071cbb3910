"""Device times of two trees' encoder-attention kernels, on one card, in turns.

    python3 compare_attention.py --other DIR [--rounds 2]

DIR holds another checkout of this repository (for example an earlier
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
The script times ``bahdanau_attend`` (B = 128, S = 80, D = A = E = 512)
and ``beam_cross_attention`` (B = 128, K = 5, S = 80, D = 512, 8 heads,
float32 and bfloat16 keys and values) of each tree by CUDA-graph replay:
10 calls captured in one graph, the replay timed with CUDA events, median
of 5, with one input set (warm in the 50 MB L2) and with two input sets in
turn (84 MB: every call reads device memory). Each tree runs in a process
of its own, which imports that tree's ``video_captioning_tpu_torch`` and
builds its kernels; the order is other, this, this, other (``--rounds``
pairs), so drift on the card shows in both. Every output is held against
the tree's own plain version first. Prints one JSON line per process and a
summary line with each tree's medians, beside the card's name and power
limit. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPEATS = 5


def _graph_ms(torch, fn, calls: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _in_turn(fns: list):
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1
    return call


def time_tree(tree: Path) -> dict:
    """Time one tree's two kernels in this process."""
    sys.path.insert(0, str(tree))
    import torch
    from video_captioning_tpu_torch.ops import attention, transformer_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"

    def attend_inputs(seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        B, S, D = 128, 80, 512
        u = lambda *s: (torch.rand(s, generator=g) * 2 - 1) / D ** 0.5  # noqa: E731
        h = torch.tanh(torch.randn((B, D), generator=g))
        enc_outs = torch.randn((B, S, D), generator=g) * 0.5
        enc_proj = torch.randn((B, S, D), generator=g) * 0.5
        lengths = torch.randint(1, S + 1, (B,), generator=g)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).float()
        mask[1] = 0.0
        return tuple(t.to(dev) for t in (h, u(D, D), u(D), enc_proj, enc_outs, u(D), u(1), mask))

    def cross_inputs(seed, dtype):
        g = torch.Generator(device="cpu").manual_seed(seed)
        B, K, S, D = 128, 5, 80, 512
        q = torch.randn((B * K, D), generator=g)
        ck = torch.randn((B, S, D), generator=g).to(dtype)
        cv = torch.randn((B, S, D), generator=g).to(dtype)
        lengths = torch.randint(1, S + 1, (B,), generator=g)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).float()
        mask[1] = 0.0
        return tuple(t.to(dev) for t in (q, ck, cv, mask))

    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    sets = [attend_inputs(8), attend_inputs(18)]
    got = attention.bahdanau_attend(*sets[0])
    want = attention.bahdanau_attend_reference(*sets[0])
    out["bahdanau_attend_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(got, want))
    out["bahdanau_attend_ms"] = _graph_ms(torch, lambda: attention.bahdanau_attend(*sets[0]))
    out["bahdanau_attend_cold_ms"] = _graph_ms(
        torch, _in_turn([lambda a=a: attention.bahdanau_attend(*a) for a in sets]))
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        sets = [cross_inputs(30 + i, dtype) for i in range(2)]
        got = transformer_attn.beam_cross_attention(*sets[0], 8, 5)
        want = transformer_attn.beam_cross_attention_reference(*sets[0], 8, 5)
        out[f"beam_cross_attention{tag}_max_abs_err"] = max(
            (a - b).abs().max().item() for a, b in zip(got, want))
        out[f"beam_cross_attention{tag}_ms"] = _graph_ms(
            torch, lambda: transformer_attn.beam_cross_attention(*sets[0], 8, 5))
        out[f"beam_cross_attention{tag}_cold_ms"] = _graph_ms(
            torch, _in_turn([lambda a=a: transformer_attn.beam_cross_attention(*a, 8, 5)
                             for a in sets]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2, help="(other, this, this, other) pairs")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)  # one tree, this process
    args = ap.parse_args(argv)
    if args.time is not None:
        import torch

        if not torch.cuda.is_available():
            print("compare_attention: no CUDA card", file=sys.stderr)
            return 1
        print(json.dumps(time_tree(args.time.resolve())), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    trees = {"other": args.other.resolve(), "this": HERE}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time",
                                   str(trees[who])], capture_output=True, text=True,
                                  cwd=trees[who], timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            line = proc.stdout.strip().splitlines()[-1]
            print(f"[{who}] {line}", flush=True)
            runs[who].append(json.loads(line))
    keys = [k for k in runs["this"][0] if k.endswith("_ms")]
    summary = {who: {k: statistics.median(r[k] for r in runs[who]) for k in keys}
               for who in runs}
    print(card)
    print(json.dumps({"card": card, "median_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
