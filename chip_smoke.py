#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing the final result line:

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: both CUDA kernels compiled with nvcc for sm_90a (ptxas report);
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes, with median times from CUDA events:
   ``topk2d_lse`` at (640, 10000), k = 5 and 16, with crafted ties, a
   constant row, a -inf tail and an all -inf row (values and indices
   exactly equal, lse within 1e-5 relative), and ``lstm_seq`` at
   (80, 2, 128, 2048) with float32 and bfloat16 xproj and ragged lengths;
4. the slice: the default full-width ``Config()`` (4096-d features, 512
   hidden, 2+2 LSTM layers, Bahdanau, V = 10000, 80 frames) with random
   weights from ``init_params_numpy(seed=0)``, the vocabulary projection
   sharpened x3 and END suppressed so every clip decodes 20 steps, written
   as an inference package, loaded by ``VideoCaptionPredictor`` on the card
   and served by ``CaptionServer``: greedy and beam-5 ``/caption``, a beam
   ``/caption_batch`` of 8, ``/healthz`` and ``/metrics``. The kernels'
   launch counters are zeroed just before the requests and read just
   after. Then ``predict_batch`` at B = 128 beam-5 on the card, and the
   first 16 clips decoded again on the CPU with ``kernels.interpret`` (the
   kernels' plain versions, same bf16-operand contract): clip-level token
   agreement must be at least 0.95;
5. a JSON line of the kernels, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

from video_captioning_tpu_torch import Config, Vocabulary
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.models.weights import init_params_numpy
from video_captioning_tpu_torch.ops import build, launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_reference
from video_captioning_tpu_torch.ops.topk import topk2d_lse, topk2d_lse_reference
from video_captioning_tpu_torch.utils.checkpoint import save_model_for_inference

# lstm_seq tolerance: the kernel and the plain version sum the recurrent
# product in different orders, and where h lands within an ulp of a bf16
# rounding boundary the two round it to neighbouring bf16 values (2^-9
# apart at |h| < 1); over 80 steps those flips spread through the row
# (about 1e-4 at the main path's shape on an H100). bf16 outputs add
# their own rounding: one bf16 ulp is 2^-7 for |c| in [1, 2).
LSTM_ATOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
TOPK_LSE_RTOL = 1e-5
MIN_CLIP_AGREEMENT = 0.95


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def time_ms(fn, calls: int, runs: int = 5) -> float:
    """Median over ``runs`` of the CUDA-event time of ``calls`` back-to-back
    calls, divided by ``calls``: the device time per call where the card is
    the bottleneck, the host's issue time where the host is."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def build_kernels() -> None:
    for name in ("topk_lse", "lstm_seq"):
        t0 = time.perf_counter()
        build.load_library(name)
        print(f"[build] {name}: ready in {time.perf_counter() - t0:.1f}s "
              f"(nvcc {' '.join(build.NVCC_FLAGS)})")
        for line in build.build_logs.get(name, "").splitlines():
            print(f"[build]   {line}")


def topk_inputs(device: str, N: int = 640, V: int = 10000) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((N, V), generator=g) * 3
    x[3, [5, 777, 9999]] = 20.0          # tie at the top
    x[4, :] = 0.5                         # constant row
    x[5, 5000:] = float("-inf")           # -inf tail
    x[6, 100:200] = x[6].max()            # run of ties
    x[7, :] = float("-inf")               # all -inf: lse = -inf
    return x.to(device)


def check_topk(device: str, card: str) -> dict:
    x = topk_inputs(device)
    result = {}
    for k in (5, 16):
        vals, idx, lse = topk2d_lse(x, k)
        rv, ri, rl = topk2d_lse_reference(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(vals, rv) and torch.equal(idx, ri)):
            bad = (vals != rv).any(dim=1) | (idx != ri).any(dim=1)
            raise AssertionError(f"topk2d_lse k={k}: values/indices differ in rows "
                                 f"{bad.nonzero().flatten()[:10].tolist()}")
        fin = torch.isfinite(rl)
        if not torch.equal(torch.isneginf(lse), torch.isneginf(rl)) or not fin.any():
            raise AssertionError(f"topk2d_lse k={k}: -inf rows differ")
        lse_err = (lse[fin] - rl[fin]).abs()
        rel = (lse_err / rl[fin].abs().clamp_min(1e-30)).max().item()
        if rel > TOPK_LSE_RTOL:
            raise AssertionError(f"topk2d_lse k={k}: lse rel err {rel:.3g} > {TOPK_LSE_RTOL}")
        ms = time_ms(lambda: topk2d_lse(x, k), calls=50)
        plain_ms = time_ms(lambda: topk2d_lse_reference(x, k), calls=20)
        print(f"[kernels] topk2d_lse (640, 10000) k={k}: values/indices exact, "
              f"lse max rel err {rel:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({card})")
        result.setdefault("main", dict(max_abs_err=lse_err.max().item(), ms=ms, plain_ms=plain_ms))
    return result["main"]


def lstm_inputs(device: str, dtype: torch.dtype, T=80, ND=2, B=128, H=512):
    g = torch.Generator(device="cpu").manual_seed(1)
    xproj = (torch.randn((T, ND, B, 4 * H), generator=g) * 0.5).to(dtype)
    w = ((torch.rand((ND, H, 4 * H), generator=g) * 2 - 1) / H ** 0.5).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T  # one full row
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.float32)
    return xproj.to(device), w.to(device), mask.to(device)


def check_lstm(device: str, card: str) -> dict:
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        xproj, w, mask = lstm_inputs(device, dtype)
        got = lstm_seq(xproj, w, mask)
        want = lstm_seq_reference(xproj, w, mask)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0]), (got[1][0], want[1][0]), (got[1][1], want[1][1])]
        err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        pad = mask.T[:, None, :, None].expand(got[0].shape) == 0
        if err > LSTM_ATOL[dtype] or bool((got[0][pad] != 0).any()):
            raise AssertionError(f"lstm_seq {dtype}: max abs err {err:.3g} > "
                                 f"{LSTM_ATOL[dtype]} or a padded step emitted nonzero")
        ms = time_ms(lambda: lstm_seq(xproj, w, mask), calls=10)
        plain_ms = time_ms(lambda: lstm_seq_reference(xproj, w, mask), calls=3)
        print(f"[kernels] lstm_seq (80, 2, 128, 2048) {dtype}: max abs err {err:.3g} "
              f"(tol {LSTM_ATOL[dtype]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        result.setdefault("main", dict(max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return result["main"]


def smoke_package(directory: str, config: Config, seed: int = 0) -> str:
    """A full-width inference package with random weights: vocabulary
    projection sharpened x3 (trained-model logit margins), END suppressed
    (every clip decodes max_length steps)."""
    V = config.model.vocab_size
    vocab = Vocabulary(config)
    for i in range(len(vocab), V):
        vocab.word2idx[f"w{i}"] = i
        vocab.idx2word[i] = f"w{i}"
    params = init_params_numpy(config, V, seed=seed)
    out_proj = params["decoder"]["output_projection"]
    out_proj["kernel"] *= 3.0
    out_proj["bias"][vocab.end_idx] = -1e9
    return str(save_model_for_inference(params, vocab, config, directory))


def _http(port: int, path: str, payload=None) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"{path}: HTTP {resp.status}")
        return json.loads(resp.read())


def _check_caption(res: dict, V: int, what: str) -> None:
    if not isinstance(res.get("caption"), str) or not res["caption"]:
        raise AssertionError(f"{what}: no caption in {str(res)[:200]}")
    if not all(0 <= t < V for t in res["tokens"]):
        raise AssertionError(f"{what}: token out of range in {res['tokens']}")


def run_slice(device: str, config: Config, clips: np.ndarray, cpu_clips: int,
              card: str) -> dict:
    V = config.model.vocab_size
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pkg = smoke_package(tmp, config)
        predictor = VideoCaptionPredictor(pkg, device=device)
        print(f"[slice] package written and loaded on {device} in "
              f"{time.perf_counter() - t0:.1f}s")
        server = CaptionServer(predictor, port=0, max_batch=8, max_wait_ms=200.0)
        server.start()
        try:
            feats = [np.round(c, 3).tolist() for c in clips[:9]]
            reset_launch_counts()
            greedy = _http(server.port, "/caption", {"features": feats[0], "method": "greedy"})
            beam = _http(server.port, "/caption",
                         {"features": feats[0], "method": "beam", "beam_size": 5})
            batch = _http(server.port, "/caption_batch",
                          {"items": [{"features": f} for f in feats[1:9]],
                           "method": "beam", "beam_size": 5})
            if device == "cuda":
                torch.cuda.synchronize()
            out["launches"] = launch_counts()
            _check_caption(greedy, V, "greedy /caption")
            _check_caption(beam, V, "beam /caption")
            if len(batch["results"]) != 8:
                raise AssertionError(f"/caption_batch returned {len(batch['results'])} results")
            for i, r in enumerate(batch["results"]):
                _check_caption(r, V, f"/caption_batch item {i}")
            health = _http(server.port, "/healthz")
            metrics = _http(server.port, "/metrics")
            if health["status"] != "ok" or metrics["requests"] != 10:
                raise AssertionError(f"healthz {health}, metrics requests {metrics['requests']}")
            print(f"[slice] served greedy {greedy['caption'][:60]!r}... and beam "
                  f"{beam['caption'][:60]!r}...; batch of 8 ok; {metrics['batches']} "
                  f"device batches; launches in the served run: {out['launches']}")
        finally:
            server.close()

        # Both kernels must have carried the served requests: lstm_seq twice
        # per encode (2 layers), topk2d_lse once per beam step (20 steps).
        n = out["launches"]
        if n["lstm_seq"] < 2 * metrics["batches"] or n["topk2d_lse"] < 2 * 20:
            raise AssertionError(f"kernel launch counts too low: {n}")

        batch = list(clips)
        predictor.predict_batch(batch[:8], method="beam", beam_size=5)  # warm
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = predictor.predict_batch(batch, method="beam", beam_size=5)
        if device == "cuda":
            torch.cuda.synchronize()
        out["beam_wall_s"] = time.perf_counter() - t0
        for i, r in enumerate(results):
            _check_caption(r, V, f"predict_batch clip {i}")
        print(f"[slice] predict_batch B={len(batch)} beam-5 on {device}: "
              f"{out['beam_wall_s']:.3f} s wall ({card}; one call, not a benchmark)")

        cpu_config = Config.from_dict(predictor.config.to_dict())
        cpu_config.kernels.interpret = True  # plain versions, same contract
        cpu_pred = VideoCaptionPredictor(pkg, config=cpu_config, device="cpu")
        cpu_results = cpu_pred.predict_batch(batch[:cpu_clips], method="beam", beam_size=5)
        same = [a["tokens"] == b["tokens"] for a, b in zip(results, cpu_results)]
        out["agreement"] = sum(same) / len(same)
        print(f"[slice] beam-5 tokens, card vs CPU plain versions, first {cpu_clips} "
              f"clips: agreement {out['agreement']:.4f}")
        if out["agreement"] < MIN_CLIP_AGREEMENT:
            raise AssertionError(f"clip agreement {out['agreement']} < {MIN_CLIP_AGREEMENT}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] nvidia-smi: {smi}; torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    topk = check_topk("cuda", smi)
    lstm = check_lstm("cuda", smi)
    config = Config()
    clips = np.random.default_rng(1).standard_normal(
        (128, config.model.video_sequence_length, config.model.cnn_feature_dim),
        dtype=np.float32)
    sl = run_slice("cuda", config, clips, cpu_clips=16, card=smi)
    kernels = []
    for name_, route, src, replaces, res in (
        ("topk2d_lse", "cuda", "video_captioning_tpu_torch/csrc/topk_lse.cu",
         "video_captioning_tpu/ops/topk_pallas.py:55", topk),
        ("lstm_seq", "cuda", "video_captioning_tpu_torch/csrc/lstm_seq.cu",
         "video_captioning_tpu/ops/lstm_seq_pallas.py:49", lstm),
    ):
        kernels.append({"name": name_, "route": route, "source": src, "replaces": replaces,
                        "launches": sl["launches"][name_], **res})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
