"""Two trees' attention kernels on one card: the two beam-attention
kernels' bits, their and bahdanau_attend's device times, and their cost
seen from the host and in the fused transformer's decode, in turns.

    python3 compare_attention.py --other DIR [--rounds 2]

DIR holds another checkout of this repository (for example an earlier
commit unpacked with ``git archive`` into the gitignored ``_scratch/``).
Each tree runs in a process of its own, which imports that tree's
``video_captioning_tpu_torch`` and builds its kernels; the order is other,
this, this, other (``--rounds`` pairs), so drift on the card shows in
both. Each process:

* runs ``beam_cross_attention`` on the same seeded inputs (this tree's
  ``chip_smoke.beam_cross_inputs``, made once and handed to every process)
  at the main shape (B = 128, K = 5, S = 80, D = 512, 8 heads; float32 and
  bfloat16 keys and values) and at every ``chip_smoke.CROSS_EDGE_SHAPES``
  entry, with the ragged mask and with none, and writes the outputs to a
  temporary file; the summary's ``same_bits`` says whether every run of
  both trees gave the same bits as the first;
* runs ``beam_self_attention`` likewise (``chip_smoke.beam_self_inputs``,
  seed 20) at ``chip_smoke.SELF_MAIN`` (B = 128, K = 5, D = 512, 8 heads,
  T = 21, t = 19) and at every ``chip_smoke.SELF_EDGE_SHAPES`` entry, in
  its three forms (``SELF_FORMS``: float32 query and caches, bfloat16
  caches, bfloat16 query and caches) and with a bfloat16 query on float32
  caches, into the same ``same_bits``; and times each of the three forms
  at the main shape by graph replay, warm and with two input sets in turn
  (cold), and by ``_host_ms``;
* times ``bahdanau_attend`` (B = 128, S = 80, D = A = E = 512) and
  ``beam_cross_attention`` at the main shape by CUDA-graph replay: 10
  calls captured in one graph, the replay timed with CUDA events, median
  of 5, with one input set (warm in the 50 MB L2) and with two input sets
  in turn (84 MB: every call reads device memory). Every output is held
  against the tree's own plain version first;
* times ``beam_cross_attention`` at the main shape in float32 as the
  decode loop meets it: ``_event_ms``, 10 wrapper calls back to back
  between CUDA events, median of 5 (the host's issue time where it exceeds
  the device's), and ``_host_ms``, the host's own time a call over 200
  calls without a sync, median of 5 (the wrapper, its allocations and
  the launches' issue);
* runs the fused transformer's decode window (the tree's own
  ``chip_smoke.fused_transformer_config`` and ``smoke_package``: random
  weights from seed 0, encode + beam-5 over 20 steps at B = 128, 40
  ``beam_cross_attention`` calls), CUDA-event time, median of 11 after two
  warm-ups, and its device busy time in one more run under torch.profiler.

Prints one JSON line per process and a summary line with ``same_bits``,
whether each self form's warm and cold medians are below the other
tree's, and each tree's medians, beside the card's name and power limit.
Exits 1 if the bits differ. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

REPEATS = 5

CROSS_MAIN = (128, 5, 80, 512, 8)
WINDOW_RUNS = 11
# beam_self_attention's forms: (key suffix, q's dtype, the caches' dtype).
SELF_FORMS = (("", torch.float32, torch.float32), ("_bf16", torch.float32, torch.bfloat16),
              ("_bf16q", torch.bfloat16, torch.bfloat16))


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


def _event_ms(torch, fn, calls: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _host_ms(torch, fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def run_in_turns(script: Path, other: Path, rounds: int, tmp: Optional[Path] = None,
                 extra: tuple = ()) -> tuple:
    """Run ``script --run TREE [--out FILE] *extra`` for each tree in the
    order other, this, this, other (``rounds`` pairs), each in a process of
    its own from the tree's root, and print each process's last line (one
    JSON object). With ``tmp``, FILE is a new path there for the outputs
    the run saves. Returns the card's name and power limit (nvidia-smi),
    each tree's results and the saved files in run order. A process that
    fails ends this one with its exit code, after its output."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    trees = {"other": other.resolve(), "this": script.resolve().parent}
    runs = {"other": [], "this": []}
    files = []
    for i in range(rounds):
        for j, who in enumerate(("other", "this", "this", "other")):
            cmd = [sys.executable, str(script.resolve()), "--run", str(trees[who]), *extra]
            if tmp is not None:
                files.append(tmp / f"{who}{i}_{j}.pt")
                cmd += ["--out", str(files[-1])]
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=trees[who],
                                  timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                sys.exit(proc.returncode)
            line = proc.stdout.strip().splitlines()[-1]
            print(f"[{who}] {line}", flush=True)
            runs[who].append(json.loads(line))
    return card, runs, files


def medians(runs: dict, suffixes: tuple = ("_ms",)) -> dict:
    """Each tree's median of every result whose key ends in one of suffixes."""
    keys = [k for k in runs["this"][0] if k.endswith(suffixes)]
    return {who: {k: statistics.median(r[k] for r in runs[who]) for k in keys} for who in runs}


def same_bits_as_first(files: list) -> dict:
    """For each saved output: whether every run gave the first run's bits."""
    first = torch.load(files[0])
    same = {k: True for k in first}
    for f in files[1:]:
        for k, v in _same_bits(first, torch.load(f)).items():
            same[k] = same[k] and v
    return same


def run_one(name: str, fn, *args) -> int:
    """One tree in this process: fn's results as one JSON line."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(fn(*args)), flush=True)
    return 0


def inputs_file(path: Path) -> None:
    """Write the bit comparison's and the self timing's inputs, on the CPU,
    from this tree's ``chip_smoke``: ``beam_cross_inputs`` (seed 30) at the
    main shape (float32 and bfloat16 K/V) and at ``CROSS_EDGE_SHAPES``;
    ``beam_self_inputs`` (seed 20, float32) at ``SELF_MAIN`` and at
    ``SELF_EDGE_SHAPES``, and a second main-shape set (seed 21) for the
    cold timing."""
    from chip_smoke import (CROSS_EDGE_SHAPES, SELF_EDGE_SHAPES, SELF_MAIN, beam_cross_inputs,
                            beam_self_inputs)

    cross = {}
    shapes = [(*CROSS_MAIN, dt) for dt in (torch.float32, torch.bfloat16)] + list(CROSS_EDGE_SHAPES)
    for B, K, S, D, H, dtype in shapes:
        cross[f"B{B}_K{K}_S{S}_D{D}_h{H}_{str(dtype)[6:]}"] = (
            H, K, beam_cross_inputs("cpu", B, K, S, D, seed=30, dtype=dtype))
    self_cases = {}
    for B, K, D, H, T, t in (SELF_MAIN,) + SELF_EDGE_SHAPES:
        self_cases[f"B{B}_K{K}_D{D}_h{H}_T{T}_t{t}"] = (
            H, K, t, beam_self_inputs("cpu", B, K, D, T, t, torch.float32, seed=20))
    B, K, D, H, T, t = SELF_MAIN
    timing = [beam_self_inputs("cpu", B, K, D, T, t, torch.float32, seed=20 + i)
              for i in range(2)]
    torch.save({"cross": cross, "self": self_cases, "self_timing": (SELF_MAIN, timing)}, path)


def cross_outputs(transformer_attn, cases: dict) -> dict:
    """beam_cross_attention's outputs on every case, with the mask and with
    none."""
    outputs = {}
    for name, (H, K, tensors) in cases.items():
        q, ck, cv, mask = (t.cuda() for t in tensors)
        for m, tag in ((mask, "mask"), (None, "none")):
            got = transformer_attn.beam_cross_attention(q, ck, cv, m, H, K)
            outputs[f"{name}_{tag}"] = [t.cpu() for t in got]
    return outputs


def self_form(tensors: tuple, q_dtype: torch.dtype, cache_dtype: torch.dtype) -> tuple:
    """One self case's operands on the card in a form's dtypes."""
    q, kc, vc, anc = tensors
    return q.to(q_dtype).cuda(), kc.to(cache_dtype).cuda(), vc.to(cache_dtype).cuda(), anc.cuda()


def self_outputs(transformer_attn, cases: dict) -> dict:
    """beam_self_attention's context on every case in every form
    (SELF_FORMS, and the bfloat16 query on float32 caches)."""
    outputs = {}
    forms = SELF_FORMS + (("_bf16q_f32c", torch.bfloat16, torch.float32),)
    for name, (H, K, t, tensors) in cases.items():
        for tag, qdt, cdt in forms:
            got = transformer_attn.beam_self_attention(*self_form(tensors, qdt, cdt), t, H, K)
            outputs[f"self_{name}{tag}"] = [got.cpu()]
    return outputs


def decode_window(smoke) -> dict:
    """The fused transformer's encode + beam-5 at B = 128 with the tree's
    own ``chip_smoke`` (``smoke``) helpers: CUDA-event ms (median of
    WINDOW_RUNS after two warm-ups) and device busy ms in one profiled
    run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    config = smoke.fused_transformer_config()
    clips = np.random.default_rng(1).standard_normal(
        (128, config.model.video_sequence_length, config.model.cnn_feature_dim),
        dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        predictor = smoke.VideoCaptionPredictor(smoke.smoke_package(tmp, config), device="cuda")
        feats = torch.from_numpy(np.stack([predictor._prepare_features(c) for c in clips]))
    feats = feats.cuda()
    vocab, config, model = predictor.vocabulary, predictor.config, predictor.model

    @torch.inference_mode()
    def window():
        enc, final, mask = smoke.encode(model, config, feats)
        return smoke.beam_mod.beam_search_generate(model, config, enc, final, vocab.start_idx,
                                                   vocab.end_idx, 20, mask, beam_size=5)

    times = []
    for i in range(WINDOW_RUNS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        window()
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")) / 1e3
    return {"fused_transformer_window_ms": statistics.median(times),
            "fused_transformer_busy_ms": busy}


def time_tree(tree: Path, out: Path, inputs: Path) -> dict:
    """Time one tree's two kernels and its fused transformer's decode in
    this process; save its beam_cross_attention outputs to ``out``."""
    sys.path.insert(0, str(tree))
    import chip_smoke as smoke  # the tree's own (its package on sys.path first)
    from video_captioning_tpu_torch.ops import attention, transformer_attn

    if not Path(smoke.__file__).resolve().parent == tree:
        raise RuntimeError(f"{smoke.__file__} is not {tree}'s chip_smoke.py")
    if not Path(transformer_attn.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{transformer_attn.__file__} is not {tree}'s")

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

    cases = torch.load(inputs)
    torch.save({**cross_outputs(transformer_attn, cases["cross"]),
                **self_outputs(transformer_attn, cases["self"])}, out)
    res = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    (B, K, D, H, T, t), timing = cases["self_timing"]
    for tag, qdt, cdt in SELF_FORMS:
        sets = [self_form(x, qdt, cdt) for x in timing]

        def call(a):
            return transformer_attn.beam_self_attention(*a, t, H, K)

        got = call(sets[0])
        want = transformer_attn.beam_self_attention_reference(*sets[0], t, H, K)
        res[f"beam_self_attention{tag}_max_abs_err"] = (
            got.float() - want.float()).abs().max().item()
        res[f"beam_self_attention{tag}_ms"] = _graph_ms(torch, lambda: call(sets[0]))
        res[f"beam_self_attention{tag}_cold_ms"] = _graph_ms(
            torch, _in_turn([lambda a=a: call(a) for a in sets]))
        res[f"beam_self_attention{tag}_host_ms"] = _host_ms(torch, lambda: call(sets[0]))
    sets = [attend_inputs(8), attend_inputs(18)]
    got = attention.bahdanau_attend(*sets[0])
    want = attention.bahdanau_attend_reference(*sets[0])
    res["bahdanau_attend_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(got, want))
    res["bahdanau_attend_ms"] = _graph_ms(torch, lambda: attention.bahdanau_attend(*sets[0]))
    res["bahdanau_attend_cold_ms"] = _graph_ms(
        torch, _in_turn([lambda a=a: attention.bahdanau_attend(*a) for a in sets]))
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        sets = [cross_inputs(30 + i, dtype) for i in range(2)]
        got = transformer_attn.beam_cross_attention(*sets[0], 8, 5)
        want = transformer_attn.beam_cross_attention_reference(*sets[0], 8, 5)
        res[f"beam_cross_attention{tag}_max_abs_err"] = max(
            (a - b).abs().max().item() for a, b in zip(got, want))
        res[f"beam_cross_attention{tag}_ms"] = _graph_ms(
            torch, lambda: transformer_attn.beam_cross_attention(*sets[0], 8, 5))
        res[f"beam_cross_attention{tag}_cold_ms"] = _graph_ms(
            torch, _in_turn([lambda a=a: transformer_attn.beam_cross_attention(*a, 8, 5)
                             for a in sets]))
        if dtype == torch.float32:
            res["beam_cross_attention_event_ms"] = _event_ms(
                torch, lambda: transformer_attn.beam_cross_attention(*sets[0], 8, 5))
            res["beam_cross_attention_host_ms"] = _host_ms(
                torch, lambda: transformer_attn.beam_cross_attention(*sets[0], 8, 5))
    res.update(decode_window(smoke))
    return res


def _same_bits(a: dict, b: dict) -> dict:
    def raw(t):
        return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)

    return {k: all(torch.equal(raw(x), raw(y)) for x, y in zip(a[k], b[k])) for k in a}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2, help="(other, this, this, other) pairs")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one tree, this process
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:
        return run_one("compare_attention", time_tree, args.run.resolve(), args.out, args.inputs)
    if args.other is None:
        ap.error("--other is required")
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.pt"
        inputs_file(inputs)
        card, runs, files = run_in_turns(Path(__file__), args.other, args.rounds, Path(tmp),
                                         ("--inputs", str(inputs)))
        same = same_bits_as_first(files)
    summary = medians(runs)
    faster = {f"beam_self_attention{tag}{kind}": summary["this"][f"beam_self_attention{tag}{kind}"]
              < summary["other"][f"beam_self_attention{tag}{kind}"]
              for tag, _, _ in SELF_FORMS for kind in ("_ms", "_cold_ms")}
    print(card)
    print(json.dumps({"card": card, "same_bits": all(same.values()),
                      "differ": sorted(k for k, v in same.items() if not v),
                      "compared": len(same), "self_faster_than_other": faster,
                      "median_ms": summary}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
