#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing the final result line:

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the three CUDA sources compiled with nvcc for sm_90a, one nvcc
   each, all started together (ptxas report);
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes, with median times from CUDA events, each with its bound
   (bytes over the HBM rate or operations over the peak rate, whichever
   is larger) and the time of the nearest PyTorch library call:
   ``topk2d_lse`` at (640, 10000), k = 5 and 16, with crafted ties, a
   constant row, a -inf tail and an all -inf row (values and indices
   exactly equal, lse within 1e-5 relative), ``lstm_seq`` at
   (80, 2, 128, 2048) with float32 and bfloat16 xproj and ragged lengths;
4. the served slice: the default full-width ``Config()`` (4096-d
   features, 512 hidden, 2+2 LSTM layers, Bahdanau, V = 10000, 80 frames)
   with random weights from ``init_params_numpy(seed=0)``, the vocabulary
   projection sharpened x3 and END suppressed so every clip decodes 20
   steps, written as an inference package, loaded by
   ``VideoCaptionPredictor`` on the card and served by ``CaptionServer``:
   greedy and beam-5 ``/caption``, a beam ``/caption_batch`` of 8,
   ``/healthz`` and ``/metrics``. The kernels' launch counters are zeroed
   just before the requests and read just after. Then ``predict_batch`` at
   B = 128 beam-5 on the card, and the first 16 clips decoded again on the
   CPU with ``kernels.interpret`` (the kernels' plain versions, same
   bf16-operand contract): clip-level token agreement must be at least
   0.95;
5. ``lstm_seq_train``'s forward (outputs, final state, the three
   residuals) and backward (dxproj, dW_hh, random cotangents) against
   their plain versions at (80, 2, 32, 2048) and (80, 2, 128, 2048);
6. the training slice at full width (``Config()``, batch 32, label
   smoothing 0.1, Adam, clip 5): 96 synthetic clips and a CSV with a
   10000-word vocabulary, ``cli.train.main`` for 2 epochs on the card with
   the launch counters zeroed just before and read just after (each
   training step launches both lstm_seq_train kernels once per encoder
   layer, validation's greedy decode ``lstm_seq``); the inference package
   it writes is loaded by ``VideoCaptionPredictor`` and captions clips.
   Then one training step at B = 8 with dropout off on the card and on
   the CPU with the plain versions (loss and every gradient compared), 10
   steps on one fixed batch that must lower the loss, and a one-off
   profile of one step at B = 32 and B = 128;
7. a JSON line of the kernels, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from video_captioning_tpu_torch import Config, Vocabulary
from video_captioning_tpu_torch.cli import train as cli_train
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model
from video_captioning_tpu_torch.models.weights import init_params_numpy, state_dict_from_jax_params
from video_captioning_tpu_torch.ops import build, launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_reference
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    lstm_seq_train_bwd,
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd,
    lstm_seq_train_fwd_reference,
)
from video_captioning_tpu_torch.ops.topk import topk2d_lse, topk2d_lse_reference
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.utils.checkpoint import save_model_for_inference

# lstm_seq tolerance: the kernel and the plain version sum the recurrent
# product in different orders, and where h lands within an ulp of a bf16
# rounding boundary the two round it to neighbouring bf16 values (2^-9
# apart at |h| < 1); over 80 steps those flips spread through the row
# (about 1e-4 at the main path's shape on an H100). bf16 outputs add
# their own rounding: one bf16 ulp is 2^-7 for |c| in [1, 2).
LSTM_ATOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# lstm_seq_train: the forward as lstm_seq. The backward's dgates are
# rounded to bf16 before the dh and dW products, so an ulp of difference
# in the float32 gate math (tanhf, expf against the CPU's) flips some of
# those roundings and the flips carry through 80 reverse steps; the error
# is held relative to the largest value of each output.
LSTM_TRAIN_FWD_ATOL = 1e-3
LSTM_TRAIN_BWD_RTOL = 1e-2
TOPK_LSE_RTOL = 1e-5
# One training step, card against CPU plain versions: the same bf16
# roundings flip where the two sum in different orders (see above), and the
# flips carry through the encoder's 80 steps into every gradient; each
# gradient's error is held relative to its largest value.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 2e-2
GRAD_FLOOR = 1e-3
MIN_CLIP_AGREEMENT = 0.95
KERNEL_SOURCES = ("topk_lse", "lstm_seq", "lstm_seq_train")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor cores,
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


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
    """One nvcc per source, all started together."""
    for name, secs in build.build_all(KERNEL_SOURCES).items():
        print(f"[build] {name}: ready in {secs:.1f}s (nvcc {' '.join(build.NVCC_FLAGS)})")
        for line in build.build_logs.get(name, "").splitlines():
            print(f"[build]   {line}")


def bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    """Least time for the work on an H100 SXM: bytes moved once over the
    memory rate, or operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
        if "main" not in result:
            N, V = x.shape
            lib_ms = time_ms(lambda: (torch.topk(x, k, dim=-1), torch.logsumexp(x, dim=-1)),
                             calls=50)
            result["main"] = dict(max_abs_err=lse_err.max().item(), ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, **bound(
                                      nbytes=4 * N * V + N * k * 8 + 4 * N,
                                      flops=3 * N * V, peak_flops=F32_FLOPS))
            print(f"[kernels] topk2d_lse k={k}: bound {result['main']['bound_ms']:.4f} ms "
                  f"({result['main']['bound_by']}), torch.topk + torch.logsumexp {lib_ms:.4f} ms")
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
        if "main" not in result:
            T, ND, B, H4 = xproj.shape
            act = T * ND * B * H4 // 4
            lstm, x = cudnn_lstm(B, device, T=T, H=H4 // 4)
            with torch.no_grad():
                lib_ms = time_ms(lambda: lstm(x), calls=10)
            result["main"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  **bound(nbytes=4 * (4 * act + B * T + act + 2 * ND * B * H4 // 4)
                                          + 2 * ND * H4 // 4 * H4,
                                          flops=2 * act * H4, peak_flops=BF16_FLOPS))
            print(f"[kernels] lstm_seq: bound {result['main']['bound_ms']:.4f} ms "
                  f"({result['main']['bound_by']}), cuDNN LSTM forward {lib_ms:.4f} ms")
    return result["main"]


def cudnn_lstm(B: int, device: str, T=80, H=512):
    """cuDNN's bidirectional LSTM layer on (T, B, H) inputs: the nearest
    PyTorch call to the recurrence kernels (it also does the input
    projection, which the kernels take precomputed)."""
    torch.backends.cudnn.allow_tf32 = False
    lstm = torch.nn.LSTM(H, H, bidirectional=True).to(device)
    x = torch.randn((T, B, H), device=device, requires_grad=True)
    return lstm, x


def check_lstm_train(device: str, card: str, B: int) -> dict:
    """Forward (outputs, final state, the three residuals) and backward
    (dxproj, dW_hh, with random cotangents) against the plain versions on
    the card, float32 xproj, ragged mask."""
    T, ND, H = 80, 2, 512
    xproj, w, mask = lstm_inputs(device, torch.float32, T=T, ND=ND, B=B, H=H)
    got = lstm_seq_train_fwd(xproj, w, mask)
    want = lstm_seq_train_fwd_reference(xproj, w, mask)
    torch.cuda.synchronize()
    names = ("outs", "h_last", "c_last", "gact", "h_keep", "c_keep")
    fwd_err = {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, got, want)}
    if max(fwd_err.values()) > LSTM_TRAIN_FWD_ATOL:
        raise AssertionError(f"lstm_seq_train_fwd B={B}: max abs err {fwd_err} > "
                             f"{LSTM_TRAIN_FWD_ATOL}")
    g = torch.Generator(device="cpu").manual_seed(2)
    douts = torch.randn((T, ND, B, H), generator=g).to(device)
    dh_last, dc_last = (torch.randn((ND, B, H), generator=g).to(device) for _ in range(2))
    res = want[3:]  # both sides read the same residuals
    bgot = lstm_seq_train_bwd(*res[:3], w, mask, douts, dh_last, dc_last)
    bwant = lstm_seq_train_bwd_reference(*res[:3], w, mask, douts, dh_last, dc_last)
    torch.cuda.synchronize()
    bwd_err = {}
    for n, a, b in zip(("dxproj", "dW_hh"), bgot, bwant):
        bwd_err[n] = ((a - b).abs().max() / b.abs().max()).item()
    if max(bwd_err.values()) > LSTM_TRAIN_BWD_RTOL:
        raise AssertionError(f"lstm_seq_train_bwd B={B}: max err relative to the largest "
                             f"value {bwd_err} > {LSTM_TRAIN_BWD_RTOL}")
    out = {"fwd": dict(max_abs_err=max(fwd_err.values())),
           "bwd": dict(max_abs_err=max((a - b).abs().max().item()
                                       for a, b in zip(bgot, bwant)))}
    out["fwd"]["ms"] = time_ms(lambda: lstm_seq_train_fwd(xproj, w, mask), calls=5)
    out["fwd"]["plain_ms"] = time_ms(lambda: lstm_seq_train_fwd_reference(xproj, w, mask),
                                     calls=1, runs=3)
    out["bwd"]["ms"] = time_ms(
        lambda: lstm_seq_train_bwd(*res[:3], w, mask, douts, dh_last, dc_last), calls=5)
    out["bwd"]["plain_ms"] = time_ms(
        lambda: lstm_seq_train_bwd_reference(*res[:3], w, mask, douts, dh_last, dc_last),
        calls=1, runs=3)
    f4 = 4  # bytes of float32
    act = T * ND * B * H
    out["fwd"].update(bound(
        nbytes=f4 * (4 * act + B * T + act + 2 * ND * B * H + 4 * act + 2 * act)
        + 2 * ND * H * 4 * H,
        flops=2 * act * 4 * H, peak_flops=BF16_FLOPS))
    out["bwd"].update(bound(
        nbytes=f4 * (4 * act + 2 * act + B * T + act + 2 * ND * B * H + 4 * act
                     + ND * H * 4 * H) + 2 * ND * H * 4 * H,
        flops=2 * act * 4 * H + 2 * (T - 1) * ND * B * H * 4 * H, peak_flops=BF16_FLOPS))
    lstm, x = cudnn_lstm(B, device)
    y, _ = lstm(x)
    dy = torch.randn_like(y)
    params = [x, *lstm.parameters()]
    out["fwd"]["library_ms"] = time_ms(lambda: lstm(x), calls=5)
    out["bwd"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(y, params, dy, retain_graph=True), calls=5)
    print(f"[kernels] lstm_seq_train ({T}, {ND}, {B}, {4 * H}) float32: forward max abs err "
          f"{fwd_err} (tol {LSTM_TRAIN_FWD_ATOL}); backward max err relative to the largest "
          f"value {bwd_err} (tol {LSTM_TRAIN_BWD_RTOL}); fwd kernel {out['fwd']['ms']:.4f} ms, "
          f"plain {out['fwd']['plain_ms']:.4f} ms, bound {out['fwd']['bound_ms']:.4f} ms, "
          f"cuDNN LSTM fwd {out['fwd']['library_ms']:.4f} ms; bwd kernel "
          f"{out['bwd']['ms']:.4f} ms, plain {out['bwd']['plain_ms']:.4f} ms, bound "
          f"{out['bwd']['bound_ms']:.4f} ms, cuDNN LSTM bwd {out['bwd']['library_ms']:.4f} ms "
          f"({card})")
    return out


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


def training_data(directory: Path, config: Config, n_clips: int = 96, seed: int = 3) -> Path:
    """``n_clips`` random (frames, feature_dim) clips as .npy files and a
    captions CSV whose captions hold ``max_vocab_size - 4`` distinct words,
    so that with ``vocab_threshold = 1`` the vocabulary is full size."""
    rng = np.random.default_rng(seed)
    T, F = config.data.frames_per_video, config.model.cnn_feature_dim
    n_words = config.data.max_vocab_size - 4
    words = [f"w{i}" for i in rng.permutation(n_words)]
    per = -(-n_words // n_clips)
    csv_path = directory / "captions.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        out = csv.writer(f)
        out.writerow(["video_id", "video_path", "feature_path", "caption"])
        for i in range(n_clips):
            feat = directory / f"clip{i:03d}.npy"
            np.save(feat, rng.standard_normal((T, F), dtype=np.float32))
            out.writerow([f"clip{i:03d}", "", str(feat), " ".join(words[i * per:(i + 1) * per])])
    return csv_path


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run_training(card: str, config: Config, device: str = "cuda", n_clips: int = 96) -> dict:
    """The training slice through ``cli.train.main``: two epochs on
    synthetic clips, then the inference package it wrote is loaded by
    ``VideoCaptionPredictor`` on ``device`` and captions clips."""
    config = Config.from_dict(config.to_dict())
    config.data.vocab_threshold = 1
    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # training.log and ensure_dirs() land in the scratch directory
        try:
            t0 = time.perf_counter()
            csv_path = training_data(Path(tmp), config, n_clips)
            cfg_path = Path(tmp) / "config.json"
            cfg_path.write_text(json.dumps(config.to_dict()))
            print(f"[train] {n_clips} clips and a {config.data.max_vocab_size}-word caption CSV "
                  f"written in {time.perf_counter() - t0:.1f}s")
            reset_launch_counts()
            t0 = time.perf_counter()
            trainer = cli_train.main(["--config", str(cfg_path), "--data-file", str(csv_path),
                                      "--checkpoint-dir", "ck", "--epochs", "2",
                                      "--device", device, "--log-level", "WARNING"])
            sync(device)
            out["launches"] = launch_counts()
            out["wall_s"] = time.perf_counter() - t0
            results = json.loads(Path("ck/training_results.json").read_text())
            steps = trainer.global_step
            losses = ([h["loss"] for h in results["train_history"]]
                      + [h["loss"] for h in results["val_history"]])
            print(f"[train] cli.train 2 epochs, {steps} steps at B={config.training.batch_size} "
                  f"on {device}: "
                  f"{out['wall_s']:.1f} s wall ({card}; one call, not a benchmark); train "
                  f"losses {[h['loss'] for h in results['train_history']]}, val losses "
                  f"{[h['loss'] for h in results['val_history']]}, BLEU-4 "
                  f"{[h.get('bleu_4') for h in results['val_history']]}; launches "
                  f"{out['launches']}")
            if not (steps > 0 and all(np.isfinite(losses))):
                raise AssertionError(f"training: {steps} steps, losses {losses}")
            for name in ("best_model.pth", "model_for_inference.pth", "vocabulary.json"):
                if not (Path("ck") / name).exists():
                    raise AssertionError(f"training wrote no {name}")
            n = out["launches"]
            if device == "cuda" and (n["lstm_seq_train_fwd"] < 2 * steps
                                     or n["lstm_seq_train_bwd"] < 2 * steps
                                     or n["lstm_seq"] == 0):
                raise AssertionError(f"training launch counts too low for {steps} steps: {n}")
            predictor = VideoCaptionPredictor("ck/model_for_inference.pth", device=device)
            clips = [np.load(Path(tmp) / f"clip{i:03d}.npy") for i in range(4)]
            for i, r in enumerate(predictor.predict_batch(clips, method="greedy")):
                if not isinstance(r["caption"], str):
                    raise AssertionError(f"trained package, clip {i}: {str(r)[:200]}")
                if not all(0 <= t < config.model.vocab_size for t in r["tokens"]):
                    raise AssertionError(f"trained package, clip {i}: token out of range")
            print(f"[train] model_for_inference.pth loaded on {predictor.device} and "
                  f"captioned 4 clips")
        finally:
            os.chdir(cwd)
    return out


def _step_batch(config: Config, B: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    V, L = config.model.vocab_size, config.model.max_sequence_length
    lengths = rng.integers(3, L + 1, B)
    live = np.arange(L)[None, :] < lengths[:, None]
    return {
        "video_features": rng.standard_normal(
            (B, config.data.frames_per_video, config.model.cnn_feature_dim), dtype=np.float32),
        "input_tokens": np.where(live, rng.integers(4, V, (B, L)), 0).astype(np.int32),
        "target_tokens": np.where(live, rng.integers(4, V, (B, L)), 0).astype(np.int32),
    }


def _model(config: Config, device: str, seed: int = 4) -> VideoCaptioningModel:
    V = config.model.vocab_size
    model = VideoCaptioningModel(config, V)
    model.load_state_dict(state_dict_from_jax_params(init_params_numpy(config, V, seed=seed),
                                                     config))
    return model.to(device)


def _loss_and_grads(config: Config, device: str, batch: dict):
    model = _model(config, device)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out = apply_model(model, config, t["video_features"], t["input_tokens"], train=True)
    loss = label_smoothed_cross_entropy(out["logits"], t["target_tokens"], 0,
                                        config.training.label_smoothing)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def check_step_parity(card: str, config: Config, device: str = "cuda", B: int = 8) -> dict:
    """Loss and every gradient of one teacher-forced training step at full
    width, dropout off, on the card (the kernels) and on the CPU with
    ``kernels.interpret`` (their plain versions, same bf16-operand
    contract)."""
    config = Config.from_dict(config.to_dict())
    config.model.encoder_dropout = config.model.decoder_dropout = 0.0
    batch = _step_batch(config, B, seed=5)
    t0 = time.perf_counter()
    loss_gpu, g_gpu = _loss_and_grads(config, device, batch)
    cpu_config = Config.from_dict(config.to_dict())
    cpu_config.kernels.interpret = True
    loss_cpu, g_cpu = _loss_and_grads(cpu_config, "cpu", batch)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    # Each gradient's error over its largest value, floored at GRAD_FLOOR of
    # the largest gradient anywhere: the score bias's gradient is zero by the
    # softmax's shift invariance, so both sides hold only rounding noise there.
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in g_cpu.values())
    grad_rel = {n: ((g_gpu[n] - g).abs().max() / g.abs().max().clamp_min(floor)).item()
                for n, g in g_cpu.items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[train] step parity B={B}, card vs CPU plain versions: loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f} (rel {loss_rel:.3g}, tol {STEP_LOSS_RTOL}); worst gradient "
          f"{worst} max err relative to its largest value {grad_rel[worst]:.3g} (tol "
          f"{STEP_GRAD_RTOL}) over {len(grad_rel)} tensors; {time.perf_counter() - t0:.1f}s")
    if loss_rel > STEP_LOSS_RTOL or grad_rel[worst] > STEP_GRAD_RTOL:
        raise AssertionError(f"step parity: loss rel {loss_rel:.3g}, {worst} {grad_rel[worst]:.3g}")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel[worst]}


def profile_train_step(trainer: VideoCaptioningTrainer, batch: dict, card: str) -> dict:
    """One-off, not a benchmark: the CUDA-event time of one training step
    (median of 3) and torch.profiler's device time of one more."""
    from torch.profiler import ProfilerActivity, profile

    B = len(batch["video_features"])
    step_ms = time_ms(lambda: trainer.train_step(batch), calls=1, runs=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    # Device-side events only (kernels and copies): a host op's device time
    # repeats that of the kernels it launched. CUPTI's own buffer event is
    # the profiler's, not the step's.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    ours = sum(e.self_device_time_total for e in rows if "vct::lstm_seq" in e.key) / 1e3
    print(f"[profile] one training step at B={B} (one-off, not a benchmark; {card}): "
          f"{step_ms:.2f} ms per step from CUDA events; device busy {busy:.2f} ms in the "
          f"profiled step, {ours:.2f} ms of it in the lstm_seq_train kernels; top device time:")
    for e in rows[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return {"step_ms": step_ms, "device_busy_ms": busy, "lstm_kernels_ms": ours}


def check_overfit_and_profile(card: str, config: Config, device: str = "cuda",
                              steps: int = 10) -> dict:
    """``steps`` optimizer steps of the trainer on one fixed batch must
    lower the loss; then, on the card, a one-off profile of one step at
    the configured batch and at B = 128."""
    config = Config.from_dict(config.to_dict())
    config.training.learning_rate = 1e-3
    config.experiment.use_tensorboard = False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        config.experiment.checkpoint_dir = Path(tmp)
        vocab = Vocabulary(config)
        trainer = VideoCaptioningTrainer(_model(config, device), config, vocab, None, None,
                                         device=device)
        batch = _step_batch(config, config.training.batch_size, seed=6)
        losses = [float(trainer.train_step(batch)) for _ in range(steps)]
        print(f"[train] {steps} steps on one fixed B={config.training.batch_size} batch: losses "
              f"{[round(x, 4) for x in losses]}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"overfit: the loss did not fall: {losses}")
        if device == "cuda":
            for B in (config.training.batch_size, 128):
                out[B] = profile_train_step(trainer, _step_batch(config, B, seed=7), card)
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
    train = check_lstm_train("cuda", smi, B=32)
    check_lstm_train("cuda", smi, B=128)
    tr = run_training(smi, config)
    check_step_parity(smi, config)
    check_overfit_and_profile(smi, config)
    launches = {k: sl["launches"][k] + tr["launches"][k] for k in sl["launches"]}
    kernels = []
    train_src = "video_captioning_tpu_torch/csrc/lstm_seq_train.cu"
    for name_, src, replaces, res in (
        ("topk2d_lse", "video_captioning_tpu_torch/csrc/topk_lse.cu",
         "video_captioning_tpu/ops/topk_pallas.py:55", topk),
        ("lstm_seq", "video_captioning_tpu_torch/csrc/lstm_seq.cu",
         "video_captioning_tpu/ops/lstm_seq_pallas.py:49", lstm),
        ("lstm_seq_train_fwd", train_src, "video_captioning_tpu/ops/lstm_seq_pallas.py:180",
         train["fwd"]),
        ("lstm_seq_train_bwd", train_src, "video_captioning_tpu/ops/lstm_seq_pallas.py:244",
         train["bwd"]),
    ):
        kernels.append({"name": name_, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name_], **res})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
