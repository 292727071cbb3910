#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing the final result line:

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the ten CUDA sources compiled with nvcc for sm_90a, one nvcc
   each, all started together (ptxas report);
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes, with median times from CUDA events, each with its bound
   (bytes over the HBM rate or operations over the peak rate, whichever
   is larger) and the time of the nearest PyTorch library call:
   ``topk2d_lse`` and ``topk2d`` at (640, 10000), k = 5 and 16, with
   crafted ties, a constant row, a -inf tail and an all -inf row (values
   and indices exactly equal, lse within 1e-5 relative), and at odd shapes
   ((37, 10001), (3, 9), a (37, 10000) tensor off 16-byte alignment; k = 1,
   5, 16, at most V), each launched twice and required bitwise equal, with
   graph-replay device times (x warm in L2, and cold: copies in turn) beside
   ``torch.topk`` + ``torch.logsumexp``'s, ``lstm_seq`` at
   (80, 2, 128, 2048) with float32 and bfloat16 xproj and ragged lengths
   (also its graph-replay device time, and at T = 1 and T = 80 for the
   fixed cost and the cost a step), then ``lstm_seq`` (both xproj types)
   and both ``lstm_seq_train`` launches at 12 small odd shapes (T in
   (1, 5), B in (1, 3, 37), H in (40, 600), a length-1 row), every LSTM
   kernel launched twice on the same inputs and required bitwise equal,
   ``lstm_cell`` at N = 640 (In = 1024 and 512) and N = 128,
   ``bahdanau_attend`` at B = 128, S = 80, D = A = E = 512 with a ragged
   mask and an all-masked row, ``vocab_topk_lse`` at (640, 512) x
   (512, 10000) and at odd shapes (N = 1, 37 with H = 200, 2560; Vp = 136)
   on integer operands (exact, ties crafted across tile and span
   boundaries) and at the main shape on random ones, each launched twice
   and required bitwise equal, with graph-replay device times (W warm in
   L2, and cold) beside the bf16 ``torch.addmm`` + ``torch.topk`` +
   ``torch.logsumexp`` composite's,
   ``beam_self_attention`` at the transformer's beam step (B = 128, K = 5,
   D = 512, 8 heads, T = 21, t = 19; float32 and bfloat16 caches) and
   ``beam_cross_attention`` (B = 128, K = 5, S = 80, D = 512, ragged mask
   with an all-masked row), each also at small odd shapes, with the
   profiler's device time beside the CUDA-event time;
4. the served slice, four times: the default full-width ``Config()`` (4096-d
   features, 512 hidden, 2+2 LSTM layers, Bahdanau, V = 10000, 80 frames),
   then the fused decode step (the same with ``use_pallas_attention``,
   ``use_pallas_lstm`` and ``use_fused_vocab_topk`` on), each with random
   weights from ``init_params_numpy(seed=0)``, the vocabulary projection
   sharpened x3 and END suppressed so every clip decodes 20 steps, written
   as an inference package, loaded by ``VideoCaptionPredictor`` on the
   card and served by ``CaptionServer``: greedy and beam-5 ``/caption``, a
   beam ``/caption_batch`` of 8, ``/healthz`` and ``/metrics``. The
   kernels' launch counters are zeroed just before the requests and read
   just after, and each configuration's kernels must have carried them
   (the fused one: every decoder cell, the greedy attention, every beam
   expansion, and no ``topk2d_lse``), then the transformer family at full
   width (``transformer_config()``: d_model 512, 2 + 2 blocks, 8 heads,
   MLP 2048, V = 10000, 80 frames) and with its fused beam attention
   (``fused_transformer_config()``: both kernels once per decoder block in
   every beam step, 2 x 20 launches of each per beam batch). Each slice
   then runs ``predict_batch`` at B = 128
   beam-5 on the card, a one-off profile of encode + beam-5, and the first
   16 (LSTM default) or 8 (the others) clips decoded again on the CPU with
   ``kernels.interpret`` (the kernels' plain versions, same contracts; the
   fused-vocabulary gate evaluated as on the card): clip-level token
   agreement must be at least 0.95;
5. ``lstm_seq_train``'s forward (outputs, final state, the three
   residuals) and backward (dxproj, dW_hh, random cotangents) against
   their plain versions at (80, 2, 32, 2048) and (80, 2, 128, 2048), each
   launched twice and required bitwise equal, with CUDA-event and
   graph-replay times, T = 1 against T = 80, and the backward's sweep and
   dW_hh launches timed apart by the profiler;
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
7. the CNN backbones: ``fused_bottleneck`` at every stage's identity
   block at B = 32 (float32; bfloat16 at stages 1 and 4), ``matmul_bias_act``
   at stage 1's conv3 with its three epilogues and ``conv1x1`` at stride 2,
   both int8 kernels at eight small odd shapes, stage 1's 1x1 shapes and
   the last block's (exactly equal to their plain versions, two launches
   bitwise equal), then at the 17 shapes of a B = 32 forward, device time
   against ``torch._int_mm`` by CUDA-graph replay, summed over its 32
   launches beside the bound; then the
   extraction slice: ``cli.preprocess.VideoFeatureExtractor`` over 2 clips
   of 80 seeded 224 x 224 frames (standing in for the OpenCV decoder) with
   VGG16 and ResNet50 ``folded``, ``fused``, ``fused_s2d``, ``int8`` without
   and with ``int8_conv1x1_pallas`` and ``fused`` in bfloat16, numpy-seeded
   weights: launch counts read around each run, the first 4 frames held
   against the CPU plain versions, one B = 32 forward timed, two profiled,
   the dataset CSV written and one VGG16 clip captioned by the LSTM default
   predictor;
8. the transformer's training slice at full width (``transformer_config()``,
   dropout 0.1, batch 32): ``cli.train.main`` for 2 epochs on 96 synthetic
   clips (no kernel launches: its teacher forcing and greedy validation
   run none), the package it writes served on the card and 8 clips' beam-5
   tokens held against the CPU run; one step at B = 8 with dropout off on
   the card and on the CPU (loss and every gradient, the LSTM's
   tolerances), 10 steps on one fixed batch that must lower the loss, and a
   one-off profile of one step at B = 32 and B = 128;
9. the remaining entry points on the LSTM default at full width, each
   launch count read around its call and held to the count the call implies
   (2 ``lstm_seq`` an encode, 20 ``topk2d_lse`` a beam search), every token
   list and caption held against the same command on the CPU with the plain
   versions: ``cli.predict single`` from features and from a video
   (``--feature-mode cnn``, VGG16 with seeded random weights, seeded frames
   in place of the OpenCV decoder), ``batch`` over 4 videos and an
   unreadable one (an error entry in its place), ``multiple`` (beam 10, 5
   captions), ``cli.evaluate`` in file mode and in dataset mode over 16
   seeded clips, and ``cli.import_reference`` of a synthetic upstream state
   dict whose package is then served;
10. a wide encoder (``encoder_hidden_dim=1024``, beyond the recurrence
   kernels' limit): 8 clips served with beam 5 and one training step, no
   ``lstm_seq*`` launch counted, the encoder's log line naming the gate
   (``lstm_seq_eligible``), tokens equal to the CPU run and the loss within
   STEP_LOSS_RTOL;
11. the LSTM decoder's other options at ``Config()`` widths
   (``run_decoder_options``): Luong dot, general and concat, multi-head
   with 8 heads and no attention, each served beam-5 at B = 128 (2
   ``lstm_seq`` and 20 ``topk2d_lse`` launches exactly) and profiled once;
   Luong general under the fused decode step (40 ``lstm_cell``, 20
   ``vocab_topk_lse``, no ``bahdanau_attend``), also through the server; the
   first 8 clips of each held against the CPU run; one training step of
   Luong general and of multi-head against the CPU;
12. ancestral sampling (``run_sampling``) on ``Config()`` at B = 128,
   temperature 0.7, top_k 0 and 10: Gumbel noise drawn once on the CPU and
   handed to the card's and the CPU's runs (the first 8 clips' tokens
   equal, log-probabilities within SAMPLE_LOGP_ATOL), then the predictor's
   own generator on the card (two predictors with one seed bitwise equal);
13. bfloat16 serving (``run_bf16_serving``): ``Config()`` with
   ``compute_dtype="bfloat16"``, greedy and beam-5 at B = 128, clip
   agreement with the CPU port's bfloat16 run (16 clips; greedy at least
   MIN_BF16_GREEDY_AGREEMENT) and with the card's float32 run (all 128),
   first-divergence positions, and encode + beam-5 timed and profiled beside
   float32;
14. a JSON line of the kernels, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import contextlib
import csv
import io
import itertools
import json
import logging
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
from video_captioning_tpu_torch.cli import evaluate as cli_evaluate
from video_captioning_tpu_torch.cli import import_reference as cli_import_reference
from video_captioning_tpu_torch.cli import predict as cli_predict
from video_captioning_tpu_torch.cli import preprocess as cli_preprocess
from video_captioning_tpu_torch.cli import train as cli_train
from video_captioning_tpu_torch.data import video as video_mod
from video_captioning_tpu_torch.generation import beam as beam_mod
from video_captioning_tpu_torch.generation import sampling as sampling_mod
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.models.attention import BahdanauAttention, attend
from video_captioning_tpu_torch.models.backbones import FeatureExtractor
from video_captioning_tpu_torch.models.backbones.resnet import _bottleneck_folded
from video_captioning_tpu_torch.models.backbones.resnet_int8 import feature_error
from video_captioning_tpu_torch.models import encoder as encoder_mod
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model, encode
from video_captioning_tpu_torch.models.weights import init_params_numpy, state_dict_from_jax_params
from video_captioning_tpu_torch.ops import build, launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.attention import bahdanau_attend, bahdanau_attend_reference
from video_captioning_tpu_torch.ops.bottleneck import (
    fused_bottleneck,
    fused_bottleneck_reference,
    kernel_plan,
)
from video_captioning_tpu_torch.ops.conv1x1 import (
    conv1x1,
    matmul_bias_act,
    matmul_bias_act_reference,
)
from video_captioning_tpu_torch.ops.int8_matmul import (
    _launch as int8_launch,
    int8_matmul_requant,
    int8_matmul_requant_reference,
    int8_matmul_residual_requant,
    int8_matmul_residual_requant_reference,
)
from video_captioning_tpu_torch.ops.lstm_cell import (
    TILES as CELL_TILES,
    kernel_tile,
    lstm_cell_fused,
    lstm_cell_reference,
)
from video_captioning_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_reference
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    lstm_seq_train_bwd,
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd,
    lstm_seq_train_fwd_reference,
)
from video_captioning_tpu_torch.ops.topk import (
    topk2d,
    topk2d_lse,
    topk2d_lse_reference,
    topk2d_reference,
)
from video_captioning_tpu_torch.ops.transformer_attn import (
    beam_cross_attention,
    beam_cross_attention_reference,
    beam_self_attention,
    beam_self_attention_reference,
    gather_beam_prefix,
)
from video_captioning_tpu_torch.ops.vocab_topk import (
    TILE_COLS as VOCAB_TILE_COLS,
    pad_vocab_weights,
    vocab_partition,
    vocab_topk_lse,
    vocab_topk_lse_reference,
)
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.utils.checkpoint import (
    load_model_for_inference,
    save_model_for_inference,
    vocabulary_from_package,
)

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
# Sampling with the same noise on the card and the CPU: each step's
# log-softmax of float32 logits that differ by sum order (about 1e-5 of
# O(10) sharpened logits), summed over 20 steps.
SAMPLE_LOGP_ATOL = 1e-3
# bfloat16 serving, card against the CPU port's bfloat16 run: the same
# parameters, but float32 sums in other orders ahead of each rounding to
# bfloat16 (activations into the projections) can flip a near-tie; the
# JAX package's own CPU test holds the port to 0.9 against JAX's bf16.
MIN_BF16_GREEDY_AGREEMENT = 0.9
# lstm_cell: the kernel takes each product by the 3xTF32 split (within
# about 2^-21 of the float32 product, lo.lo dropped) and sums in float32, in
# another order than the plain version's float32 products; over In + H =
# 1536 terms of O(1) gates the two land a few 1e-6 apart (no bf16 rounding;
# tests/test_torch_decode_kernels.py holds the split's share to a quarter).
LSTM_CELL_ATOL = 2e-5
# bahdanau_attend: the JAX kernel test's tolerance
# (tests/test_pallas_kernels.py:45); float32, sums in different orders.
ATTN_TOL = 1e-5
# vocab_topk_lse on random operands: the kernel and the plain version sum
# the 512 exact bf16 products in different orders, so a logit may differ
# by float32 rounding of the sum; values are held within VOCAB_RTOL of the
# largest |logit|, indices where the neighbouring values are further apart.
VOCAB_RTOL = 1e-5
# beam_self_attention / beam_cross_attention: float32 sums in different
# orders (the self kernel's online softmax rescales as it goes) over at
# most 80 terms of O(1) values; bfloat16 caches are widened exactly on
# both sides, so the same tolerance holds.
BEAM_ATTN_ATOL = 1e-5
# fused_bottleneck and matmul_bias_act: float32 sums of up to 9 * 512
# products in different orders (fused_bottleneck's products by the 3xTF32
# split, each within about 2^-21 of the float32 product; its share is held
# to a quarter by tests/test_torch_cnn_kernels.py), held relative to the
# largest |output|; in bfloat16 the kernel and the plain version round y1
# and y2 from sums in different orders, so a value can land one bf16 step
# (2^-8 relative) away and carry through the next product: 1e-2 of the
# largest |output|.
CNN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# The extraction slice, card against the CPU plain versions on the same
# frames: float32 relative L2; the JAX bf16 contract (mean |d| / mean |f32|,
# tests/test_backbones.py:436); int8 mean cosine (the JAX cross contract)
# and int8 against folded float32 (cosine, relative L2; test_backbones.py
# :461-462).
FEAT_F32_REL_L2 = 1e-3
FEAT_BF16_MEAN_REL = 0.15
FEAT_INT8_COS = 0.995
INT8_VS_F32 = (0.99, 0.12)
KERNEL_SOURCES = ("topk_lse", "lstm_seq", "lstm_seq_train", "lstm_cell", "bahdanau_attend",
                  "vocab_topk", "transformer_attn", "fused_bottleneck", "conv1x1", "int8_matmul")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 and TF32 tensor
# cores, float32 outside the tensor cores, int8 tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12


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


def bound(nbytes: float, flops: float, peak_flops: float, tf32x3: bool = False) -> dict:
    """Least time for the work on an H100 SXM: bytes moved once over the
    memory rate, or operations over the peak rate for their type. With
    ``tf32x3`` (float32 products taken as three TF32 products on the tensor
    cores) also ``tf32x3_bound_ms``: 3 x operations over the TF32 peak, or
    the bytes' time, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    res = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if tf32x3:
        t_tc = 3 * flops / TF32_FLOPS * 1e3
        res.update(tf32x3_bound_ms=max(t_bytes, t_tc),
                   tf32x3_bound_by="bytes" if t_bytes >= t_tc else "operations")
    return res


def topk_inputs(device: str, N: int = 640, V: int = 10000, offset: int = 0,
                seed: int = 0) -> torch.Tensor:
    """Seeded (N, V) logits with crafted rows: a tie at the top, a constant
    row, a -inf tail, a run of ties, an all -inf row (the rows that exist).
    ``offset`` elements of storage before the first row leave every row
    off 16-byte alignment."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((N, V), generator=g) * 3
    crafted = ((3, lambda r: r.index_fill_(0, torch.tensor([0, V // 2, V - 1]), 20.0)),
               (4, lambda r: r.fill_(0.5)),
               (5, lambda r: r[V // 2:].fill_(float("-inf"))),
               (6, lambda r: r[V // 3:V // 3 + V // 100 + 2].fill_(r.max().item())),
               (7, lambda r: r.fill_(float("-inf"))))
    for row, craft in crafted:
        if row < N:
            craft(x[row])
    flat = torch.empty(N * V + offset, device=device)
    flat[offset:] = x.flatten().to(device)
    return flat[offset:].view(N, V)


# Odd shapes of the top-k kernels, (N, V, offset): the scalar tail of a
# row with V % 4 != 0, k > V / 2 on a short row, a row off 16-byte
# alignment with V % 4 == 0.
TOPK_ODD_CASES = ((37, 10001, 0), (3, 9, 0), (37, 10000, 1))


def _topk_exact(name: str, fn, ref, x: torch.Tensor, k: int) -> float:
    """The kernel against its plain version: values and indices exactly
    equal; with an lse, -inf rows alike and the rest within TOPK_LSE_RTOL;
    a second launch bitwise equal to the first. Returns the lse's largest
    absolute error (0 without one)."""
    got, want = fn(x, k), ref(x, k)
    again = fn(x, k)
    torch.cuda.synchronize()
    shape = tuple(x.shape)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = (got[0] != want[0]).any(dim=1) | (got[1] != want[1]).any(dim=1)
        raise AssertionError(f"{name} {shape} k={k}: values/indices differ in rows "
                             f"{bad.nonzero().flatten()[:10].tolist()}")
    if not same_bits(got, again):
        raise AssertionError(f"{name} {shape} k={k}: two launches differ")
    if len(got) < 3:
        return 0.0
    lse, rl = got[2], want[2]
    fin = torch.isfinite(rl)
    if not torch.equal(torch.isneginf(lse), torch.isneginf(rl)) or not fin.any():
        raise AssertionError(f"{name} {shape} k={k}: -inf rows differ")
    lse_err = (lse[fin] - rl[fin]).abs()
    rel = (lse_err / rl[fin].abs().clamp_min(1e-30)).max().item()
    if rel > TOPK_LSE_RTOL:
        raise AssertionError(f"{name} {shape} k={k}: lse rel err {rel:.3g} > {TOPK_LSE_RTOL}")
    return lse_err.max().item()


def cold_copies(x: torch.Tensor, total_bytes: float = 100e6) -> list:
    """Copies of x that together exceed the 50 MB L2, for a rotation in
    which every call finds its input in device memory."""
    return [x.clone() for _ in range(max(2, int(-(-total_bytes // (x.numel() * x.element_size())))))]


def _rotating(fn, inputs: list):
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def _topk_phase(name: str, fn, ref, lib_fn, lse: bool, device: str, card: str) -> dict:
    """Odd shapes, then the beam step's shape at k = 5 and 16 with event,
    graph-replay (x warm in L2, as the beam step finds its logits after the
    vocabulary GEMM) and cold graph-replay times beside the library call's."""
    for N, V, offset in TOPK_ODD_CASES:
        x = topk_inputs(device, N, V, offset, seed=N + V)
        for k in (1, 5, 16):
            _topk_exact(name, fn, ref, x, min(k, V))
    lse_note = f", lse within {TOPK_LSE_RTOL}" if lse else ""
    print(f"[kernels] {name} odd shapes {list(TOPK_ODD_CASES)} (N, V, offset) at k = 1, 5, "
          f"16 (at most V): values/indices exact{lse_note}, two launches bitwise equal")
    x = topk_inputs(device)
    N, V = x.shape
    result = {}
    for k in (5, 16):
        err = _topk_exact(name, fn, ref, x, k)
        ms = time_ms(lambda: fn(x, k), calls=50)
        plain_ms = time_ms(lambda: ref(x, k), calls=20)
        g_ms = graph_ms(lambda: fn(x, k), calls=20)
        cold = cold_copies(x)
        cold_ms = graph_ms(_rotating(lambda z: fn(z, k), [(c,) for c in cold]), calls=2 * len(cold))
        lib_ms = time_ms(lambda: lib_fn(x, k), calls=50)
        lib_g = graph_ms(lambda: lib_fn(x, k), calls=20)
        n_cold = len(cold)
        del cold
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, graph_ms=g_ms,
                   cold_graph_ms=cold_ms, library_ms=lib_ms, library_graph_ms=lib_g,
                   **bound(nbytes=4 * N * V + N * k * 8 + (4 * N if lse else 0),
                           flops=(3 if lse else 1) * N * V, peak_flops=F32_FLOPS))
        print(f"[kernels] {name} (640, 10000) k={k}: values/indices exact"
              f"{f', lse max abs err {err:.3g}' if lse else ''}, two launches bitwise equal; "
              f"kernel {ms:.4f} ms (events), device "
              f"{g_ms:.4f} ms (graph replay, x warm in L2), {cold_ms:.4f} ms (x cold: "
              f"{n_cold} copies in turn); bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {res['bound_ms'] / g_ms:.3f} of it "
              f"reached warm); library {lib_ms:.4f} ms (events), device {lib_g:.4f} ms; plain "
              f"{plain_ms:.4f} ms ({card})")
        result.setdefault("main", res)
    return result["main"]


def check_topk(device: str, card: str) -> dict:
    return _topk_phase("topk2d_lse", topk2d_lse, topk2d_lse_reference,
                       lambda z, k: (torch.topk(z, k, dim=-1), torch.logsumexp(z, dim=-1)),
                       True, device, card)


def lstm_inputs(device: str, dtype: torch.dtype, T=80, ND=2, B=128, H=512, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    xproj = (torch.randn((T, ND, B, 4 * H), generator=g) * 0.5).to(dtype)
    w = ((torch.rand((ND, H, 4 * H), generator=g) * 2 - 1) / H ** 0.5).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T  # one full row
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.float32)
    return xproj.to(device), w.to(device), mask.to(device)


def bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, for bitwise comparison."""
    return x.contiguous().view(torch.int16 if x.element_size() == 2 else torch.int32)


def same_bits(a, b) -> bool:
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def graph_step_ms(fn_of_T, T_long: int = 80) -> dict:
    """Device time (graph_ms) of a launch at T = 1 and at T = T_long: the
    fixed cost, and the cost of each further step."""
    t1, tl = graph_ms(fn_of_T(1), calls=10), graph_ms(fn_of_T(T_long), calls=3)
    return {"T1_graph_ms": t1, f"T{T_long}_graph_ms": tl, "step_us": (tl - t1) / (T_long - 1) * 1e3}


def check_lstm(device: str, card: str) -> dict:
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        xproj, w, mask = lstm_inputs(device, dtype)
        got = lstm_seq(xproj, w, mask)
        want = lstm_seq_reference(xproj, w, mask)
        again = lstm_seq(xproj, w, mask)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0]), (got[1][0], want[1][0]), (got[1][1], want[1][1])]
        err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        pad = mask.T[:, None, :, None].expand(got[0].shape) == 0
        if err > LSTM_ATOL[dtype] or bool((got[0][pad] != 0).any()):
            raise AssertionError(f"lstm_seq {dtype}: max abs err {err:.3g} > "
                                 f"{LSTM_ATOL[dtype]} or a padded step emitted nonzero")
        if not same_bits((got[0], *got[1]), (again[0], *again[1])):
            raise AssertionError(f"lstm_seq {dtype}: two launches on the same inputs differ")
        ms = time_ms(lambda: lstm_seq(xproj, w, mask), calls=10)
        dev_ms = graph_ms(lambda: lstm_seq(xproj, w, mask))
        plain_ms = time_ms(lambda: lstm_seq_reference(xproj, w, mask), calls=3)
        print(f"[kernels] lstm_seq (80, 2, 128, 2048) {dtype}: max abs err {err:.3g} "
              f"(tol {LSTM_ATOL[dtype]}), two launches bitwise equal; kernel {ms:.4f} ms "
              f"(graph {dev_ms:.4f} ms), plain {plain_ms:.4f} ms ({card})")
        T, ND, B, H4 = xproj.shape
        act = T * ND * B * H4 // 4
        esz = xproj.element_size()
        lim = bound(nbytes=esz * (4 * act + act + 2 * ND * B * H4 // 4) + 4 * B * T
                    + 2 * ND * H4 // 4 * H4, flops=2 * act * H4, peak_flops=BF16_FLOPS)
        lstm, x = cudnn_lstm(B, device, T=T, H=H4 // 4, dtype=dtype)
        with torch.no_grad():
            lib_ms = time_ms(lambda: lstm(x), calls=10)
        if dtype == torch.bfloat16:
            print(f"[kernels] lstm_seq {dtype}: bound {lim['bound_ms']:.4f} ms "
                  f"({lim['bound_by']}), cuDNN LSTM forward in {dtype} {lib_ms:.4f} ms ({card})")
        if "main" not in result:
            def seq_call(n):
                x_n, m_n = xproj[:n], mask[:, :n].contiguous()
                return lambda: lstm_seq(x_n, w, m_n)

            steps = graph_step_ms(seq_call)
            result["main"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  graph_ms=dev_ms, **steps, **lim)
            print(f"[kernels] lstm_seq: bound {result['main']['bound_ms']:.4f} ms "
                  f"({result['main']['bound_by']}), cuDNN LSTM forward {lib_ms:.4f} ms; "
                  f"graph T=1 {steps['T1_graph_ms']:.4f} ms, T=80 {steps['T80_graph_ms']:.4f} "
                  f"ms: {steps['step_us']:.3f} us a step ({card})")
    return result["main"]


# Small odd shapes the kernels' tiling must take: B not a multiple of the
# row chunks, H = 40 (not a multiple of 16 or 32) and H = 600 (the largest),
# T = 1 (no recurrent product) and 5; a ragged mask whose last row has
# length 1 (row 0 full).
LSTM_EDGE_SHAPES = tuple((T, B, H) for T in (1, 5) for B in (1, 3, 37) for H in (40, 600))


def lstm_edge_inputs(device: str, dtype: torch.dtype, T: int, B: int, H: int):
    xproj, w, mask = lstm_inputs(device, dtype, T=T, B=B, H=H, seed=T * 1000 + B * 10 + H)
    mask[-1] = 0.0
    mask[-1, 0] = 1.0  # a length-1 row (the only row at B = 1)
    return xproj, w, mask


def check_lstm_edges(device: str, card: str) -> None:
    """``lstm_seq`` (float32 and bfloat16 xproj) and both ``lstm_seq_train``
    launches against their plain versions at LSTM_EDGE_SHAPES, each
    launched twice and required bitwise equal, with the main shapes'
    tolerances."""
    worst = {"lstm_seq": 0.0, "train_fwd": 0.0, "train_bwd": 0.0}
    for T, B, H in LSTM_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xproj, w, mask = lstm_edge_inputs(device, dtype, T, B, H)
            got = lstm_seq(xproj, w, mask)
            again = lstm_seq(xproj, w, mask)
            want = lstm_seq_reference(xproj, w, mask)
            sync(device)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip((got[0], *got[1]), (want[0], *want[1])))
            if err > LSTM_ATOL[dtype] or not same_bits((got[0], *got[1]), (again[0], *again[1])):
                raise AssertionError(f"lstm_seq {dtype} T={T} B={B} H={H}: max abs err "
                                     f"{err:.3g} (tol {LSTM_ATOL[dtype]}) or two launches differ")
            worst["lstm_seq"] = max(worst["lstm_seq"], err)
        xproj, w, mask = lstm_edge_inputs(device, torch.float32, T, B, H)
        got = lstm_seq_train_fwd(xproj, w, mask)
        again = lstm_seq_train_fwd(xproj, w, mask)
        want = lstm_seq_train_fwd_reference(xproj, w, mask)
        sync(device)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        if err > LSTM_TRAIN_FWD_ATOL or not same_bits(got, again):
            raise AssertionError(f"lstm_seq_train_fwd T={T} B={B} H={H}: max abs err {err:.3g} "
                                 f"(tol {LSTM_TRAIN_FWD_ATOL}) or two launches differ")
        worst["train_fwd"] = max(worst["train_fwd"], err)
        g = torch.Generator(device="cpu").manual_seed(3)
        douts = torch.randn((T, 2, B, H), generator=g).to(device)
        dh_last, dc_last = (torch.randn((2, B, H), generator=g).to(device) for _ in range(2))
        res = want[3:]
        bgot = lstm_seq_train_bwd(*res, w, mask, douts, dh_last, dc_last)
        bagain = lstm_seq_train_bwd(*res, w, mask, douts, dh_last, dc_last)
        bwant = lstm_seq_train_bwd_reference(*res, w, mask, douts, dh_last, dc_last)
        sync(device)
        # dW_hh is all zeros at T = 1 (h_prev = 0): held absolutely there.
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1.0 if T == 1 else 0.0)).item()
                  for a, b in zip(bgot, bwant))
        if rel > LSTM_TRAIN_BWD_RTOL or not same_bits(bgot, bagain):
            raise AssertionError(f"lstm_seq_train_bwd T={T} B={B} H={H}: max err relative to "
                                 f"the largest value {rel:.3g} (tol {LSTM_TRAIN_BWD_RTOL}) or "
                                 f"two launches differ")
        worst["train_bwd"] = max(worst["train_bwd"], rel)
    print(f"[kernels] lstm_seq and lstm_seq_train at {len(LSTM_EDGE_SHAPES)} odd shapes "
          f"(T in (1, 5), B in (1, 3, 37), H in (40, 600), a length-1 row): worst errors "
          f"{worst} (lstm_seq abs, fwd abs, bwd relative to the largest value), every kernel "
          f"launched twice bitwise equal ({card})")


def cudnn_lstm(B: int, device: str, T=80, H=512, dtype=torch.float32):
    """cuDNN's bidirectional LSTM layer on (T, B, H) inputs: the nearest
    PyTorch call to the recurrence kernels (it also does the input
    projection, which the kernels take precomputed)."""
    torch.backends.cudnn.allow_tf32 = False
    lstm = torch.nn.LSTM(H, H, bidirectional=True).to(device, dtype)
    x = torch.randn((T, B, H), device=device, dtype=dtype, requires_grad=True)
    return lstm, x


def check_lstm_train(device: str, card: str, B: int) -> dict:
    """Forward (outputs, final state, the three residuals) and backward
    (dxproj, dW_hh, with random cotangents) against the plain versions on
    the card, float32 xproj, ragged mask; each launched twice and required
    bitwise equal. Times: CUDA events, graph replay, the sweep and dW_hh
    launches apart (profiler), T = 1 against T = 80."""
    T, ND, H = 80, 2, 512
    xproj, w, mask = lstm_inputs(device, torch.float32, T=T, ND=ND, B=B, H=H)
    got = lstm_seq_train_fwd(xproj, w, mask)
    again = lstm_seq_train_fwd(xproj, w, mask)
    want = lstm_seq_train_fwd_reference(xproj, w, mask)
    torch.cuda.synchronize()
    names = ("outs", "h_last", "c_last", "gact", "h_keep", "c_keep")
    fwd_err = {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, got, want)}
    if max(fwd_err.values()) > LSTM_TRAIN_FWD_ATOL:
        raise AssertionError(f"lstm_seq_train_fwd B={B}: max abs err {fwd_err} > "
                             f"{LSTM_TRAIN_FWD_ATOL}")
    if not same_bits(got, again):
        raise AssertionError(f"lstm_seq_train_fwd B={B}: two launches on the same inputs differ")
    g = torch.Generator(device="cpu").manual_seed(2)
    douts = torch.randn((T, ND, B, H), generator=g).to(device)
    dh_last, dc_last = (torch.randn((ND, B, H), generator=g).to(device) for _ in range(2))
    res = want[3:]  # both sides read the same residuals

    def fwd_call(n):
        x_n, m_n = xproj[:n], mask[:, :n].contiguous()
        return lambda: lstm_seq_train_fwd(x_n, w, m_n)

    def bwd_call(n):
        r_n, m_n = [r[:n] for r in res], mask[:, :n].contiguous()
        return lambda: lstm_seq_train_bwd(*r_n, w, m_n, douts[:n], dh_last, dc_last)

    fwd, bwd = fwd_call(T), bwd_call(T)
    bgot = bwd()
    bagain = bwd()
    bwant = lstm_seq_train_bwd_reference(*res[:3], w, mask, douts, dh_last, dc_last)
    torch.cuda.synchronize()
    bwd_err = {}
    for n, a, b in zip(("dxproj", "dW_hh"), bgot, bwant):
        bwd_err[n] = ((a - b).abs().max() / b.abs().max()).item()
    if max(bwd_err.values()) > LSTM_TRAIN_BWD_RTOL:
        raise AssertionError(f"lstm_seq_train_bwd B={B}: max err relative to the largest "
                             f"value {bwd_err} > {LSTM_TRAIN_BWD_RTOL}")
    if not same_bits(bgot, bagain):
        raise AssertionError(f"lstm_seq_train_bwd B={B}: two launches on the same inputs differ")
    out = {"fwd": dict(max_abs_err=max(fwd_err.values())),
           "bwd": dict(max_abs_err=max((a - b).abs().max().item()
                                       for a, b in zip(bgot, bwant)))}
    out["fwd"]["ms"] = time_ms(fwd, calls=5)
    out["fwd"]["graph_ms"] = graph_ms(fwd)
    out["fwd"].update(graph_step_ms(fwd_call))
    out["fwd"]["plain_ms"] = time_ms(lambda: lstm_seq_train_fwd_reference(xproj, w, mask),
                                     calls=1, runs=3)
    out["bwd"]["ms"] = time_ms(bwd, calls=5)
    out["bwd"]["graph_ms"] = graph_ms(bwd)
    out["bwd"].update(graph_step_ms(bwd_call))
    out["bwd"]["sweep_device_ms"] = device_ms(bwd, calls=5, keys=("lstm_seq_bwd",))
    out["bwd"]["dw_device_ms"] = device_ms(bwd, calls=5, keys=("lstm_seq_dw",))
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
    dw_bound = bound(nbytes=f4 * ((T - 1) * ND * B * H * 5 + ND * H * 4 * H),
                     flops=2 * (T - 1) * ND * B * H * 4 * H, peak_flops=BF16_FLOPS)
    out["bwd"]["dw_bound_ms"] = dw_bound["bound_ms"]
    lstm, x = cudnn_lstm(B, device)
    y, _ = lstm(x)
    dy = torch.randn_like(y)
    params = [x, *lstm.parameters()]
    out["fwd"]["library_ms"] = time_ms(lambda: lstm(x), calls=5)
    out["bwd"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(y, params, dy, retain_graph=True), calls=5)
    f, b_ = out["fwd"], out["bwd"]
    print(f"[kernels] lstm_seq_train ({T}, {ND}, {B}, {4 * H}) float32: forward max abs err "
          f"{fwd_err} (tol {LSTM_TRAIN_FWD_ATOL}); backward max err relative to the largest "
          f"value {bwd_err} (tol {LSTM_TRAIN_BWD_RTOL}); both launched twice bitwise equal; "
          f"fwd kernel {f['ms']:.4f} ms (graph {f['graph_ms']:.4f} ms; T=1 "
          f"{f['T1_graph_ms']:.4f} ms, {f['step_us']:.3f} us a step), plain "
          f"{f['plain_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms, cuDNN LSTM fwd "
          f"{f['library_ms']:.4f} ms; bwd kernels {b_['ms']:.4f} ms (graph {b_['graph_ms']:.4f} "
          f"ms; T=1 {b_['T1_graph_ms']:.4f} ms, {b_['step_us']:.3f} us a step; profiler: sweep "
          f"{b_['sweep_device_ms']:.4f} ms, dW_hh {b_['dw_device_ms']:.4f} ms against its bound "
          f"{b_['dw_bound_ms']:.4f} ms), plain {b_['plain_ms']:.4f} ms, bound "
          f"{b_['bound_ms']:.4f} ms, cuDNN LSTM bwd {b_['library_ms']:.4f} ms ({card})")
    return out


def check_topk2d(device: str, card: str) -> dict:
    """The k-only top-k (the same kernel, logsumexp compiled out) as
    check_topk, against torch.topk."""
    return _topk_phase("topk2d", topk2d, topk2d_reference,
                       lambda z, k: torch.topk(z, k, dim=-1), False, device, card)


def lstm_cell_inputs(device: str, N: int, In: int, H: int = 512, seed: int = 7):
    """A decoder layer's weights as torch initialises an LSTM, in their
    stored (4H, In) layout, and (x, h, c) at decode-time scales."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = 1.0 / H ** 0.5

    def u(*shape):
        return ((torch.rand(shape, generator=g) * 2 - 1) * r).to(device)

    layer = {"w_ih": u(4 * H, In), "w_hh": u(4 * H, H), "b_ih": u(4 * H), "b_hh": u(4 * H)}
    x = torch.randn((N, In), generator=g).to(device)
    h = torch.tanh(torch.randn((N, H), generator=g)).to(device)
    c = torch.randn((N, H), generator=g).to(device)
    return layer, x, h, c


# Odd cell shapes: N a multiple of no tile's rows, In = 13 (the 4-byte copy
# path), H = 40 (a ragged last unit block).
LSTM_CELL_EDGE_SHAPES = tuple((N, In, H) for N in (1, 37, 129) for In in (13, 512)
                              for H in (40, 512))


def _cell_pair(layer, x, h, c, tile: int = -1):
    """Two launches on the same inputs: both outputs, and whether they are
    bitwise equal."""
    got = lstm_cell_fused(layer, x, h, c, tile=tile)
    again = lstm_cell_fused(layer, x, h, c, tile=tile)
    return got, same_bits(got, again)


def check_lstm_cell(device: str, card: str) -> dict:
    """The cell kernel against its plain version at the beam step's rows
    (N = B*K = 640) for both decoder layers (In = emb + E = 1024 and
    In = H = 512), at the greedy step's N = 128, and at odd shapes, with
    every tile forced in turn; every launch twice, bitwise equal; h and c,
    which the beam loop still reads, must come back untouched. Device times
    (CUDA-graph replay) of the kernel, each tile, and torch.lstm_cell."""
    worst = 0.0
    for N, In, H in LSTM_CELL_EDGE_SHAPES:
        layer, x, h, c = lstm_cell_inputs(device, N, In, H)
        want = lstm_cell_reference(layer, x, h, c)
        for tile in (-1, *range(len(CELL_TILES))):
            got, same = _cell_pair(layer, x, h, c, tile)
            sync(device)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            worst = max(worst, err)
            if err > LSTM_CELL_ATOL or not same:
                raise AssertionError(f"lstm_cell N={N} In={In} H={H} tile {tile}: max abs err "
                                     f"{err:.3g} > {LSTM_CELL_ATOL}, or two launches differ")
    print(f"[kernels] lstm_cell odd shapes N in (1, 37, 129), In in (13, 512), H in (40, 512), "
          f"every tile: max abs err {worst:.3g} (tol {LSTM_CELL_ATOL}), two launches bitwise "
          f"equal")
    results = {}
    for N, In in ((640, 1024), (640, 512), (128, 1024)):
        layer, x, h, c = lstm_cell_inputs(device, N, In)
        h0, c0 = h.clone(), c.clone()
        got, same = _cell_pair(layer, x, h, c)
        want = lstm_cell_reference(layer, x, h, c)
        sync(device)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if err > LSTM_CELL_ATOL or not same or not (torch.equal(h, h0) and torch.equal(c, c0)):
            raise AssertionError(f"lstm_cell N={N} In={In}: max abs err {err:.3g} > "
                                 f"{LSTM_CELL_ATOL}, two launches differ, or an input was "
                                 f"written")
        H = h.shape[1]

        def library():
            return torch.lstm_cell(x, [h, c], layer["w_ih"], layer["w_hh"], layer["b_ih"],
                                   layer["b_hh"])

        res = dict(max_abs_err=err, ms=time_ms(lambda: lstm_cell_fused(layer, x, h, c), 50),
                   plain_ms=time_ms(lambda: lstm_cell_reference(layer, x, h, c), 50),
                   library_ms=time_ms(library, 50),
                   graph_ms=graph_ms(lambda: lstm_cell_fused(layer, x, h, c), 20),
                   library_graph_ms=graph_ms(library, 20),
                   **bound(nbytes=4 * (N * In + 4 * N * H + 4 * H * (In + H) + 8 * H),
                           flops=2 * N * 4 * H * (In + H), peak_flops=F32_FLOPS, tf32x3=True))
        tiles = {CELL_TILES[t]: graph_ms(lambda: lstm_cell_fused(layer, x, h, c, tile=t), 20)
                 for t in range(len(CELL_TILES))}
        results[(N, In)] = res
        print(f"[kernels] lstm_cell N={N} In={In} H={H}: max abs err {err:.3g} (tol "
              f"{LSTM_CELL_ATOL}), two launches bitwise equal, inputs untouched; kernel "
              f"{res['ms']:.4f} ms (device {res['graph_ms']:.4f} ms, CUDA graph; tile "
              f"{kernel_tile(N, H) if device == 'cuda' else None}), plain {res['plain_ms']:.4f} "
              f"ms, torch.lstm_cell {res['library_ms']:.4f} ms (device "
              f"{res['library_graph_ms']:.4f} ms); bound {res['bound_ms']:.4f} ms (float32 "
              f"CUDA cores, {res['bound_by']}), {res['tf32x3_bound_ms']:.4f} ms (3xTF32 tensor "
              f"cores, {res['tf32x3_bound_by']}); device ms by tile (rows, units) "
              f"{ {k: round(v, 4) for k, v in tiles.items()} } ({card})")
    return results[(640, 1024)]


def attention_inputs(device: str, B: int = 128, S: int = 80, D: int = 512, A: int = 512,
                     E: int = 512, seed: int = 8):
    """One decode step's attention operands; ragged frame counts, row 1
    all masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = 1.0 / D ** 0.5

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * r

    h = torch.tanh(torch.randn((B, D), generator=g))
    enc_outs = torch.randn((B, S, E), generator=g) * 0.5
    enc_proj = torch.randn((B, S, A), generator=g) * 0.5
    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0] = S
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(torch.float32)
    mask[1] = 0.0
    args = (h, u(A, D), u(A), enc_proj, enc_outs, u(A), u(1), mask)
    return tuple(a.to(device) for a in args)


def check_attention(device: str, card: str) -> dict:
    """The attention step against its plain version at B = 128 (the greedy
    batch), D = A = E = 512, S = 80: context and weights within ATTN_TOL,
    the all-masked row uniform."""
    args = attention_inputs(device)
    h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask = args
    got = bahdanau_attend(*args)
    want = bahdanau_attend_reference(*args)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    rel = max(((a - b).abs() / b.abs().clamp_min(1.0)).max().item() for a, b in zip(got, want))
    S = mask.shape[1]
    uniform = (got[1][1] - 1.0 / S).abs().max().item()
    if rel > ATTN_TOL or uniform > 1e-7 or not torch.isfinite(got[0]).all():
        raise AssertionError(f"bahdanau_attend: max err {err:.3g} (rel {rel:.3g}) > {ATTN_TOL}, "
                             f"or the all-masked row is {uniform:.3g} from uniform")
    B, D = h.shape
    A, E = enc_proj.shape[2], enc_outs.shape[2]
    cfg = Config()
    attn = BahdanauAttention(cfg).to(device)
    with torch.no_grad():
        attn.decoder_projection.weight.copy_(w_d)
        attn.decoder_projection.bias.copy_(b_d)
        attn.attention_linear.weight.copy_(v[None])
        attn.attention_linear.bias.copy_(b_v)
        cache = {"enc_proj": enc_proj}
        res = dict(max_abs_err=err, ms=time_ms(lambda: bahdanau_attend(*args), 50),
                   graph_ms=graph_ms(lambda: bahdanau_attend(*args)),
                   plain_ms=time_ms(lambda: bahdanau_attend_reference(*args), 50),
                   library_ms=time_ms(lambda: attend(cfg, attn, cache, enc_outs, h, mask), 50),
                   library_graph_ms=graph_ms(lambda: attend(cfg, attn, cache, enc_outs, h, mask)),
                   **bound(nbytes=4 * (B * D + A * D + 2 * A + 1 + B * S * (A + E)
                                       + 2 * B * S + B * E),
                           flops=2 * B * A * D + 3 * B * S * A + 2 * B * S * E,
                           peak_flops=F32_FLOPS))
    print(f"[kernels] bahdanau_attend B={B} S={S} D=A=E={D}: max abs err {err:.3g} (tol "
          f"{ATTN_TOL}), all-masked row uniform within {uniform:.3g}; kernel {res['ms']:.4f} ms "
          f"(device {res['graph_ms']:.4f} ms by graph replay), plain {res['plain_ms']:.4f} ms, "
          f"eager attend (a 7-call composite) {res['library_ms']:.4f} ms (device "
          f"{res['library_graph_ms']:.4f} ms), bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}) ({card})")
    return res


# Odd shapes of vocab_topk_lse, (N, H, V, pad_vocab_weights' vt): one row,
# a ragged row block with H = 200 (H % 32 != 0), the most rows the beam
# step sends it (FUSED_VOCAB_MAX_ROWS), and Vp = 136 (a 128-column tile and
# an 8-column one).
VOCAB_ODD_CASES = ((1, 512, 10000, 128), (37, 200, 10000, 128), (2560, 512, 10000, 128),
                   (37, 512, 136, 8))


def span_tie_columns(N: int, H: int, Vp: int, V: int) -> list:
    """Vocabulary columns on both sides of the kernel's first two span
    boundaries and of the first tile boundary, and the last column: where
    a crafted tie must cross the kernel's merges."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    step = vocab_partition(N, H, Vp, n_sm)["tiles_per_span"] * VOCAB_TILE_COLS
    cols = {VOCAB_TILE_COLS - 1, VOCAB_TILE_COLS, V - 1}
    for edge in list(range(step, Vp, step))[:2]:
        cols |= {edge - 1, edge}
    return sorted(c for c in cols if c < V)


def vocab_int_inputs(device: str, N: int, H: int, V: int, vt: int, seed: int):
    """Integer-valued operands (every product and sum exact in float32),
    padded; row 0 selects row 0 of W, whose tie columns hold 100 against at
    most 11 elsewhere. Returns (x, w_pad, b_pad, tie columns)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(-3, 4, (N, H), generator=g).float()
    W = torch.randint(-3, 4, (H, V), generator=g).float()
    b = torch.randint(-8, 9, (V,), generator=g).float()
    ties = span_tie_columns(N, H, -(-V // vt) * vt, V)
    x[0] = 0.0
    x[0, 0] = 1.0
    W[0, ties] = 100.0
    b[ties] = 0.0
    w_pad, b_pad, _ = pad_vocab_weights(W.to(device), b.to(device), vt=vt)
    return x.to(device), w_pad, b_pad, ties


def _vocab_exact(x, w_pad, b_pad, k: int, ties: list) -> float:
    """Integer operands: values and indices equal to the plain version's,
    row 0's ties in ascending column order, the lse within TOPK_LSE_RTOL,
    two launches bitwise equal. Returns the lse's relative error."""
    got, want = vocab_topk_lse(x, w_pad, b_pad, k), vocab_topk_lse_reference(x, w_pad, b_pad, k)
    again = vocab_topk_lse(x, w_pad, b_pad, k)
    torch.cuda.synchronize()
    what = f"vocab_topk_lse integer operands {tuple(x.shape)} x {tuple(w_pad.shape)} k={k}"
    rel = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max().item()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) or rel > TOPK_LSE_RTOL:
        bad = (got[0] != want[0]).any(dim=1) | (got[1] != want[1]).any(dim=1)
        raise AssertionError(f"{what}: values/indices differ in rows "
                             f"{bad.nonzero().flatten()[:10].tolist()} or lse rel err {rel:.3g}")
    n = min(k, len(ties))
    if got[1][0, :n].tolist() != ties[:n]:
        raise AssertionError(f"{what}: tie order {got[1][0, :n].tolist()}, want {ties[:n]}")
    if not same_bits(got, again):
        raise AssertionError(f"{what}: two launches differ")
    return rel


def check_vocab_topk(device: str, card: str) -> dict:
    """The fused vocabulary kernel against its plain version. Integer-valued
    operands make every product and sum exact in float32, so values and
    indices must be equal, ties crafted across tile and span boundaries
    included, at the beam step's shape (N = 640, H = 512, V = 10000) and at
    VOCAB_ODD_CASES; on random operands values are held within VOCAB_RTOL
    of the largest |logit| and indices where neighbouring values are
    further apart than that. Every case is launched twice and must repeat
    bitwise."""
    N, H, V = 640, 512, 10000
    rel = 0.0
    for (n, h, v, vt), ks in [((N, H, V, 128), (5, 16))] + [(c, (1, 16)) for c in VOCAB_ODD_CASES]:
        x, w_pad, b_pad, ties = vocab_int_inputs(device, n, h, v, vt, seed=9 + n + h)
        for k in ks:
            rel = max(rel, _vocab_exact(x, w_pad, b_pad, k, ties))
        print(f"[kernels] vocab_topk_lse integer operands ({n}, {h}) x ({h}, {w_pad.shape[1]}), "
              f"k = {ks}: values/indices exact, ties at columns {ties} in order, two launches "
              f"bitwise equal")
    print(f"[kernels] vocab_topk_lse integer operands: lse max rel err {rel:.3g}")

    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn((N, H), generator=g).to(device)
    W = (torch.randn((H, V), generator=g) * 0.05).to(device)
    b = (torch.randn((V,), generator=g) * 0.1).to(device)
    w_pad, b_pad, v_pad = pad_vocab_weights(W, b)
    k = 5
    vals, idx, lse = vocab_topk_lse(x, w_pad, b_pad, k)
    again = vocab_topk_lse(x, w_pad, b_pad, k)
    rv, ri, rl = vocab_topk_lse_reference(x, w_pad, b_pad, k + 1)
    torch.cuda.synchronize()
    logits = x.to(torch.bfloat16).float() @ w_pad.float() + b_pad
    tol = VOCAB_RTOL * logits[:, :V].abs().max().item()
    val_err = (vals - rv[:, :k]).abs().max().item()
    separated = (rv[:, :-1] - rv[:, 1:] > tol).all(dim=1)
    idx_ok = (idx == ri[:, :k]).all(dim=1) | ~separated
    rel = ((lse - rl).abs() / rl.abs()).max().item()
    if val_err > tol or not idx_ok.all() or rel > TOPK_LSE_RTOL:
        raise AssertionError(f"vocab_topk_lse random operands: value err {val_err:.3g} > {tol:.3g}"
                             f", index mismatch in separated rows "
                             f"{(~idx_ok).nonzero().flatten()[:10].tolist()}, lse rel {rel:.3g}")
    if not same_bits((vals, idx, lse), again):
        raise AssertionError("vocab_topk_lse random operands: two launches differ")
    x16, b16 = x.to(torch.bfloat16), b_pad.to(torch.bfloat16)

    def library():
        z = torch.addmm(b16, x16, w_pad)
        return torch.topk(z, k, dim=-1), torch.logsumexp(z, dim=-1)

    cold = cold_copies(w_pad)
    operands = [(x, w, b_pad) for w in cold]
    res = dict(max_abs_err=val_err, ms=time_ms(lambda: vocab_topk_lse(x, w_pad, b_pad, k), 20),
               graph_ms=graph_ms(lambda: vocab_topk_lse(x, w_pad, b_pad, k), calls=20),
               cold_graph_ms=graph_ms(_rotating(lambda *a: vocab_topk_lse(*a, k), operands),
                                      calls=2 * len(cold)),
               plain_ms=time_ms(lambda: vocab_topk_lse_reference(x, w_pad, b_pad, k), 10),
               library_ms=time_ms(library, 20), library_graph_ms=graph_ms(library, calls=20),
               **bound(nbytes=4 * N * H + 2 * H * v_pad + 4 * v_pad + N * k * 8 + 4 * N,
                       flops=2 * N * H * v_pad, peak_flops=BF16_FLOPS))
    n_cold = len(cold)
    del cold, operands
    print(f"[kernels] vocab_topk_lse random operands k={k}: value err {val_err:.3g} (tol "
          f"{tol:.3g}), indices equal in all {int(separated.sum())} rows whose top {k + 1} are "
          f"separated by more than the tol (of {N}), lse max rel err {rel:.3g}, two launches "
          f"bitwise equal; kernel (all launches of a call) {res['ms']:.4f} ms (events), device "
          f"{res['graph_ms']:.4f} ms (graph replay; x and W warm in L2, as the beam step's "
          f"repeated calls find W), {res['cold_graph_ms']:.4f} ms (W cold: {n_cold} copies in "
          f"turn); plain {res['plain_ms']:.4f} ms; bf16 torch.addmm + torch.topk + "
          f"torch.logsumexp (a 3-call composite) {res['library_ms']:.4f} ms (events), device "
          f"{res['library_graph_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}, {res['bound_ms'] / res['graph_ms']:.3f} of it reached warm) "
          f"({card})")
    return res


def device_ms(fn, calls: int, keys: tuple) -> float:
    """Device time per call of the kernels whose names contain one of
    ``keys``, from torch.profiler over ``calls`` calls after a warm-up: the
    card's own time, where a CUDA-event time of a call shorter than its
    host-side issue is the host's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in keys))
    return total / 1e3 / calls


def graph_ms(fn, calls: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in a CUDA graph, its
    replay timed with CUDA events (median of 5), so the host's launch path
    (checks, ctypes) is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, calls=1) / calls


def time_layers_ms(fn, layers: list, calls: int) -> float:
    """Per-call time of ``fn`` over inputs that alternate between
    ``layers`` (one input set per decoder layer, as the beam step calls
    it), so repeated calls do not find one layer's operands in L2."""
    return time_ms(lambda: [fn(*a) for a in layers], calls) / len(layers)


def beam_self_inputs(device: str, B: int, K: int, D: int, T: int, t: int, dtype: torch.dtype,
                     seed: int):
    """One layer's operands at step t: q, caches with rows 0..t written
    (zeros after), a random ancestry with column t the identity."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    N = B * K
    q = torch.randn((N, D), generator=g)
    caches = torch.randn((2, T, N, D), generator=g)
    caches[:, t + 1:] = 0.0
    anc = torch.randint(0, K, (B, K, T), generator=g, dtype=torch.int32)
    anc[:, :, t] = torch.arange(K, dtype=torch.int32)
    return (q.to(device), caches[0].to(dtype).to(device), caches[1].to(dtype).to(device),
            anc.to(device))


def check_beam_self_attention(device: str, card: str) -> dict:
    """The ancestry-select self-attention kernel against its plain version
    at the fused beam step's shape (B = 128, K = 5, D = 512, 8 heads, T = 21,
    t = 19; float32 and bfloat16 caches) and at a small odd shape (B = 3,
    K = 2, D = 64, 4 heads, T = 9, t = 0, 4 and 8)."""
    for dtype in (torch.float32, torch.bfloat16):
        for t in (0, 4, 8):
            q, k, v, anc = beam_self_inputs(device, 3, 2, 64, 9, t, dtype, seed=10 + t)
            err = (beam_self_attention(q, k, v, anc, t, 4, 2)
                   - beam_self_attention_reference(q, k, v, anc, t, 4, 2)).abs().max().item()
            if not err <= BEAM_ATTN_ATOL:
                raise AssertionError(f"beam_self_attention B=3 K=2 D=64 t={t} {dtype}: max abs "
                                     f"err {err:.3g}")
    print(f"[kernels] beam_self_attention B=3 K=2 D=64 h=4 T=9, t = 0, 4, 8, float32 and "
          f"bfloat16 caches: within {BEAM_ATTN_ATOL}")
    B, K, D, H, T, t = 128, 5, 512, 8, 21, 19
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        layers = [beam_self_inputs(device, B, K, D, T, t, dtype, seed=20 + i) for i in range(2)]
        q, k, v, anc = layers[0]
        got = beam_self_attention(q, k, v, anc, t, H, K)
        want = beam_self_attention_reference(q, k, v, anc, t, H, K)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= BEAM_ATTN_ATOL:
            raise AssertionError(f"beam_self_attention {dtype}: max abs err {err:.3g} > "
                                 f"{BEAM_ATTN_ATOL}")
        ms = time_layers_ms(lambda *a: beam_self_attention(*a, t, H, K), layers, calls=50)
        dev = device_ms(lambda: [beam_self_attention(*a, t, H, K) for a in layers], 20,
                        ("beam_self_attn_kernel",)) / len(layers)
        plain_ms = time_layers_ms(lambda *a: beam_self_attention_reference(*a, t, H, K),
                                  layers, calls=20)

        def library(q, k, v, anc):
            N, dh = B * K, D // H
            kh, vh = (gather_beam_prefix(c, anc, t).float().reshape(t + 1, N, H, dh)
                      .permute(1, 2, 0, 3) for c in (k, v))
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(N, H, 1, dh), kh, vh)

        lib_ms = time_layers_ms(library, layers, calls=20)
        # Bytes the step needs: the distinct physical rows the beams select
        # (both caches), the ancestry prefix, q and the context.
        rows = (torch.arange(B, device=device)[:, None, None] * K + anc[:, :, :t + 1].long())
        distinct = sum(torch.unique(rows[:, :, tau]).numel() for tau in range(t + 1))
        esize = k.element_size()
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(nbytes=2 * distinct * D * esize + 4 * B * K * (t + 1)
                           + 2 * 4 * B * K * D,
                           flops=4 * B * K * (t + 1) * D, peak_flops=F32_FLOPS))
        print(f"[kernels] beam_self_attention B={B} K={K} D={D} h={H} T={T} t={t} {dtype} "
              f"caches: max abs err {err:.3g} (tol {BEAM_ATTN_ATOL}); kernel {ms:.4f} ms "
              f"(device time {dev:.4f} ms, profiler), plain "
              f"{plain_ms:.4f} ms, torch.gather + SDPA {lib_ms:.4f} ms, bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {distinct} distinct rows of "
              f"{(t + 1) * B * K}); two layers' inputs alternate ({card})")
        result.setdefault("main", res)
    return result["main"]


def beam_cross_inputs(device: str, B: int, K: int, S: int, D: int, seed: int,
                      dtype: torch.dtype = torch.float32):
    """q, un-expanded keys and values, a ragged mask with row 1 fully masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B * K, D), generator=g)
    ck = torch.randn((B, S, D), generator=g).to(dtype)
    cv = torch.randn((B, S, D), generator=g).to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0] = S
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(torch.float32)
    mask[1] = 0.0
    return tuple(x.to(device) for x in (q, ck, cv, mask))


def check_beam_cross_attention(device: str, card: str) -> dict:
    """The one-query cross-attention kernel against its plain version at
    the fused beam step's shape (B = 128, K = 5, S = 80, D = 512, 8 heads)
    and at small odd shapes (B = 3, K = 2, S = 9 and 41, D = 64, 4 heads;
    float32 and bfloat16 keys and values), each with a ragged mask whose
    row 1 is fully masked (uniform weights), and with no mask."""
    shapes = [(3, 2, S, 64, 4, dt) for S in (9, 41) for dt in (torch.float32, torch.bfloat16)]
    result = {}
    for B, K, S, D, H, dtype in shapes + [(128, 5, 80, 512, 8, torch.float32)]:
        layers = [beam_cross_inputs(device, B, K, S, D, seed=30 + i, dtype=dtype)
                  for i in range(2)]
        q, ck, cv, mask = layers[0]
        err = 0.0
        for m in (mask, None):
            got = beam_cross_attention(q, ck, cv, m, H, K)
            want = beam_cross_attention_reference(q, ck, cv, m, H, K)
            torch.cuda.synchronize()
            err = max(err, max((a - b).abs().max().item() for a, b in zip(got, want)))
            if m is not None:
                uniform = (got[1][K:2 * K] - 1.0 / S).abs().max().item()
        if not (err <= BEAM_ATTN_ATOL and uniform <= 1e-7):
            raise AssertionError(f"beam_cross_attention B={B} K={K} S={S} D={D}: max abs err "
                                 f"{err:.3g}, fully masked row {uniform:.3g} from uniform")
        if B == 3:
            print(f"[kernels] beam_cross_attention B=3 K=2 S={S} D=64 h=4 {dtype}: within "
                  f"{BEAM_ATTN_ATOL}, ragged mask and none, masked row uniform")
            continue
        ms = time_layers_ms(lambda *a: beam_cross_attention(*a, H, K), layers, calls=50)
        dev = device_ms(lambda: [beam_cross_attention(*a, H, K) for a in layers], 20,
                        ("beam_cross_attn_kernel", "head_mean_kernel")) / len(layers)
        plain_ms = time_layers_ms(lambda *a: beam_cross_attention_reference(*a, H, K),
                                  layers, calls=20)

        def library(q, ck, cv, mask):
            dh = D // H
            add = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(B, K, H, dh).transpose(1, 2), ck.reshape(B, S, H, dh).transpose(1, 2),
                cv.reshape(B, S, H, dh).transpose(1, 2), attn_mask=add)

        lib_ms = time_layers_ms(library, layers, calls=50)
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(nbytes=4 * (2 * B * S * D + B * S + 2 * B * K * D + B * K * S),
                           flops=4 * B * K * S * D, peak_flops=F32_FLOPS))
        print(f"[kernels] beam_cross_attention B={B} K={K} S={S} D={D} h={H} float32: max abs "
              f"err {err:.3g} (tol {BEAM_ATTN_ATOL}), masked row uniform within {uniform:.3g}; "
              f"kernel {ms:.4f} ms (device time {dev:.4f} ms, profiler, both launches), plain "
              f"{plain_ms:.4f} ms, SDPA (context only) {lib_ms:.4f} "
              f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); two layers' inputs "
              f"alternate ({card})")
        result["main"] = res
    return result["main"]


# ---------------------------------------------------------------------------
# The CNN backbones' kernels and the feature-extraction slice.

# ResNet50's identity-block shapes (H = W, C, Cm) by stage.
RESNET_STAGES = ((56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512))


def bottleneck_inputs(device: str, B: int, H: int, W: int, C: int, Cm: int,
                      dtype: torch.dtype, seed: int):
    """A block input after a ReLU and folded weights at He-normal scale."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def he(*shape, fan_in):
        return torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5

    x = torch.randn((B, H, W, C), generator=g).abs()
    ws = [he(Cm, C, fan_in=C), torch.randn(Cm, generator=g) * 0.1,
          he(Cm, Cm, 3, 3, fan_in=9 * Cm), torch.randn(Cm, generator=g) * 0.1,
          he(C, Cm, fan_in=Cm) * 0.2, torch.randn(C, generator=g) * 0.1]
    ws = [w.to(dtype).to(device) for w in ws]
    ws[2] = ws[2].contiguous(memory_format=torch.channels_last)
    return x.to(dtype).to(device), ws


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# Small odd shapes (C or Cm not a multiple of 16 bytes take the element
# copies), and shapes that fill a cluster's work item partly: B = 3 and 5
# against two images an item, Cm = 160 (a cluster of 3, its last CTA half
# filled), 14 x 14 against a tiled item.
BOTTLENECK_EDGE_SHAPES = ((2, 5, 7, 24, 8), (1, 9, 9, 64, 16), (3, 11, 4, 40, 12),
                          (2, 5, 7, 22, 6), (1, 6, 5, 20, 12), (3, 7, 7, 256, 64),
                          (5, 14, 14, 128, 32), (3, 7, 7, 512, 160))
# Identity blocks of a ResNet50 forward at each stage: 2 + 3 + 5 + 2 = 12.
RESNET_IDENTITY_BLOCKS = (2, 3, 5, 2)


def check_fused_bottleneck(device: str, card: str) -> dict:
    """The fused block against its plain version at the odd and partly
    filled shapes above and at every stage's identity block at B = 32, in
    float32 and bfloat16, every launch twice and bitwise equal; the work
    item the launcher picks; the library call is the unfused block through
    cuDNN (three convs with their biases, the residual add and the ReLUs),
    TF32 off, timed by CUDA events and by CUDA-graph replay beside the
    kernel."""
    torch.backends.cudnn.allow_tf32 = False
    for shape in BOTTLENECK_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, ws = bottleneck_inputs(device, *shape[:3], *shape[3:], dtype, seed=40)
            got, again = fused_bottleneck(x, *ws), fused_bottleneck(x, *ws)
            err = _rel_err(got, fused_bottleneck_reference(x, *ws))
            if not err <= CNN_RTOL[dtype] or not same_bits((got,), (again,)):
                raise AssertionError(f"fused_bottleneck {shape} {dtype}: err {err:.3g}, or two "
                                     f"launches differ")
    print(f"[kernels] fused_bottleneck odd and partly filled shapes {BOTTLENECK_EDGE_SHAPES} "
          f"(B, H, W, C, Cm), float32 and bfloat16: within {CNN_RTOL}, two launches bitwise "
          f"equal")
    result, forward = {}, {}
    for stage, (H, C, Cm) in enumerate(RESNET_STAGES, start=1):
        for dtype in (torch.float32, torch.bfloat16):
            B = 32
            x, ws = bottleneck_inputs(device, B, H, H, C, Cm, dtype, seed=41 + stage)
            got, again = fused_bottleneck(x, *ws), fused_bottleneck(x, *ws)
            want = fused_bottleneck_reference(x, *ws)
            sync(device)
            err = _rel_err(got, want)
            if not err <= CNN_RTOL[dtype] or not same_bits((got,), (again,)):
                raise AssertionError(f"fused_bottleneck stage {stage} {dtype}: max err over the "
                                     f"largest |output| {err:.3g} > {CNN_RTOL[dtype]}, or two "
                                     f"launches differ")
            ms = time_ms(lambda: fused_bottleneck(x, *ws), calls=10)
            dev = graph_ms(lambda: fused_bottleneck(x, *ws))
            plain_ms = time_ms(lambda: fused_bottleneck_reference(x, *ws), calls=5)
            block = {"conv1": {"w": ws[0], "b": ws[1]}, "conv2": {"kernel": ws[2], "b": ws[3]},
                     "conv3": {"w": ws[4], "b": ws[5]}}
            xn = x.permute(0, 3, 1, 2)
            lib_ms = time_ms(lambda: _bottleneck_folded(block, xn, 1, False), calls=10)
            lib_dev = graph_ms(lambda: _bottleneck_folded(block, xn, 1, False))
            esize = x.element_size()
            f32 = dtype == torch.float32
            res = dict(max_abs_err=(got.float() - want.float()).abs().max().item(), ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev,
                       library_device_ms=lib_dev,
                       **bound(nbytes=esize * (2 * x.numel() + sum(w.numel() for w in ws)),
                               flops=2 * B * H * H * (2 * C * Cm + 9 * Cm * Cm),
                               peak_flops=F32_FLOPS if f32 else BF16_FLOPS, tf32x3=f32))
            n = RESNET_IDENTITY_BLOCKS[stage - 1]
            fwd = forward.setdefault(dtype, {"kernel": 0.0, "cudnn": 0.0})
            fwd["kernel"] += n * dev
            fwd["cudnn"] += n * lib_dev
            plan = kernel_plan(x, Cm) if device == "cuda" else None
            tc = (f", {res['tf32x3_bound_ms']:.4f} ms (3xTF32 tensor cores, "
                  f"{res['tf32x3_bound_by']})" if f32 else "")
            print(f"[kernels] fused_bottleneck stage {stage} (B={B}, {H}x{H}, C={C}, Cm={Cm}) "
                  f"{dtype}: max err over the largest |output| {err:.3g} (tol "
                  f"{CNN_RTOL[dtype]}), two launches bitwise equal; work item {plan}; kernel "
                  f"{ms:.4f} ms (device {dev:.4f} ms, CUDA graph), plain {plain_ms:.4f} ms, "
                  f"cuDNN unfused block {lib_ms:.4f} ms (device {lib_dev:.4f} ms); bound "
                  f"{res['bound_ms']:.4f} ms ({'float32 CUDA cores' if f32 else 'bf16'}, "
                  f"{res['bound_by']}){tc} ({card})")
            result.setdefault("main", res)
    for dtype, fwd in forward.items():
        print(f"[kernels] fused_bottleneck {dtype}: the 12 identity blocks of a B = 32 forward "
              f"(2 + 3 + 5 + 2 a stage) {fwd['kernel']:.4f} ms of device time, cuDNN's unfused "
              f"blocks {fwd['cudnn']:.4f} ms ({card})")
    return result["main"]


def check_conv1x1(device: str, card: str) -> dict:
    """matmul_bias_act against its plain version at stage 1's conv3 (M =
    100352, K = 64, N = 256) with a residual, without one, and with
    relu=False and a residual; conv1x1 at stride 2 (a stage-2 downsample);
    a small odd shape in float32 and bfloat16."""
    g = torch.Generator(device="cpu").manual_seed(50)

    def inputs(M, K, N, dtype=torch.float32):
        t = (torch.randn((M, K), generator=g), torch.randn((N, K), generator=g) / K ** 0.5,
             torch.randn(N, generator=g) * 0.1, torch.randn((M, N), generator=g))
        return tuple(a.to(dtype).to(device) for a in t)

    for dtype in (torch.float32, torch.bfloat16):
        x, w, b, r = inputs(37, 13, 9, dtype)
        for res, relu in ((r, True), (None, True), (r, False)):
            err = _rel_err(matmul_bias_act(x, w, b, res, relu=relu),
                           matmul_bias_act_reference(x, w, b, res, relu=relu))
            if not err <= CNN_RTOL[dtype]:
                raise AssertionError(f"matmul_bias_act (37, 13, 9) {dtype}: err {err:.3g}")
    x, w, b, r = inputs(100352, 64, 256)
    result = None
    for name, res, relu in (("residual + relu", r, True), ("relu", None, True),
                            ("residual, relu=False", r, False)):
        got = matmul_bias_act(x, w, b, res, relu=relu)
        want = matmul_bias_act_reference(x, w, b, res, relu=relu)
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        if not err <= CNN_RTOL[torch.float32] or (not relu and not (got < 0).any()):
            raise AssertionError(f"matmul_bias_act {name}: err {err:.3g}")
        ms = time_ms(lambda: matmul_bias_act(x, w, b, res, relu=relu), calls=20)
        plain_ms = time_ms(lambda: matmul_bias_act_reference(x, w, b, res, relu=relu), calls=20)
        print(f"[kernels] matmul_bias_act (100352, 64) x (64, 256) {name} float32: max err over "
              f"the largest |output| {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({card})")
        if result is None:
            M, K = x.shape
            N = w.shape[0]
            lib_ms = time_ms(lambda: torch.relu(torch.nn.functional.linear(x, w, b) + r),
                             calls=20)
            dev = graph_ms(lambda: matmul_bias_act(x, w, b, res, relu=relu))
            result = dict(max_abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, device_ms=dev,
                          **bound(nbytes=4 * (M * K + N * K + N + 2 * M * N),
                                  flops=2 * M * K * N, peak_flops=F32_FLOPS))
            print(f"[kernels] matmul_bias_act residual + relu: device {dev:.4f} ms (CUDA graph), "
                  f"bound {result['bound_ms']:.4f} ms ({result['bound_by']}), F.linear + add + "
                  f"relu (a 3-call composite) {lib_ms:.4f} ms")
    x4 = torch.randn((32, 56, 56, 256), generator=g).to(device)
    w4, b4 = (torch.randn((512, 256), generator=g) / 16).to(device), torch.zeros(512, device=device)
    got = conv1x1(x4, w4, b4, stride=2, relu=False)
    want = matmul_bias_act_reference(x4[:, ::2, ::2].reshape(-1, 256), w4, b4, relu=False)
    err = _rel_err(got.reshape(-1, 512), want)
    if got.shape != (32, 28, 28, 512) or not err <= CNN_RTOL[torch.float32]:
        raise AssertionError(f"conv1x1 stride 2: {tuple(got.shape)}, err {err:.3g}")
    print(f"[kernels] conv1x1 stride 2 (32, 56, 56, 256) -> (32, 28, 28, 512): err {err:.3g}; "
          f"small odd shape (37, 13, 9) float32 and bfloat16, three epilogues: within {CNN_RTOL}")
    return result


def int8_inputs(device: str, M: int, K: int, N: int, seed: int):
    """Post-ReLU int8 activations, int8 weights, a per-channel scale that
    puts y within the int8 range of s_out = 0.1, biases, an int8 identity."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    xq = torch.randint(0, 128, (M, K), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    scale = torch.rand(N, generator=g) * 4.0 / (64 * 73 * K ** 0.5)
    bias = torch.randn(N, generator=g) * 0.5
    idq = torch.randint(-127, 128, (M, N), generator=g, dtype=torch.int8)
    return tuple(t.to(device) for t in (xq, wq, scale, bias, idq))


# Small odd shapes at the int8 kernel's edges: K = 13 (the wrapper's padded
# path), K = 16 and 48 (a partial 64-byte stage), K = 2048 (a full ring);
# M = 1 and M not a multiple of any tile side; N not a multiple of 8 (byte
# loads of idq and byte stores); the last two take the 128 x 64 tile, the
# others the 64 x 64 one, with ragged edges. Each tile is also forced at
# every shape.
INT8_EDGE_SHAPES = ((37, 13, 9), (70, 16, 72), (1, 64, 64), (1, 2048, 9), (333, 2048, 100),
                    (333, 48, 200), (4001, 80, 1000), (8191, 96, 1030))
# (kernel, M, K, N, int8 out, launches) of one B = 32 int8 ResNet50
# forward with kernels.int8_conv1x1_pallas: 20 requant and 12 residual
# launches at 17 shapes.
INT8_FORWARD_SHAPES = (
    ("requant", 100352, 64, 64, True, 1), ("requant", 100352, 64, 256, False, 1),
    ("requant", 100352, 256, 64, True, 2), ("residual", 100352, 64, 256, True, 2),
    ("requant", 100352, 256, 128, True, 1), ("requant", 25088, 128, 512, False, 1),
    ("requant", 25088, 512, 128, True, 3), ("residual", 25088, 128, 512, True, 3),
    ("requant", 25088, 512, 256, True, 1), ("requant", 6272, 256, 1024, False, 1),
    ("requant", 6272, 1024, 256, True, 5), ("residual", 6272, 256, 1024, True, 5),
    ("requant", 6272, 1024, 512, True, 1), ("requant", 1568, 512, 2048, False, 1),
    ("requant", 1568, 2048, 512, True, 2), ("residual", 1568, 512, 2048, True, 1),
    ("residual", 1568, 512, 2048, False, 1),
)


# The tile shapes the int8 launcher picks from, by the index that forces one,
# and the build whose requant divides every output.
INT8_TILES = ("64x64", "128x64")
INT8_DIVIDE_ALL = ("VCT_INT8_DIVIDE_ALL=1",)


def _int8_calls(name: str, xq, wq, scale, bias, idq, s_id: float, so, relu: bool = True):
    """(kernel call, plain-version call) of one int8 kernel on fixed inputs."""
    if name == "requant":
        return (lambda: int8_matmul_requant(xq, wq, scale, bias, so, relu),
                lambda: int8_matmul_requant_reference(xq, wq, scale, bias, so, relu))
    return (lambda: int8_matmul_residual_requant(xq, wq, scale, bias, idq, s_id, so),
            lambda: int8_matmul_residual_requant_reference(xq, wq, scale, bias, idq, s_id, so))


def _int8_equal(name: str, shape: tuple, so, fn, ref) -> torch.Tensor:
    """Two kernel launches, bitwise equal to each other and to the plain
    version; returns the result."""
    got, again, want = fn(), fn(), ref()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"int8 {name} {shape} s_out={so}: two launches differ")
    if not torch.equal(got, want):
        n_bad = (got != want).sum().item()
        raise AssertionError(f"int8 {name} {shape} s_out={so}: {n_bad} entries differ from the "
                             f"plain version")
    return got


def _int8_bound(name: str, M: int, K: int, N: int, int8_out: bool) -> dict:
    return bound(nbytes=M * K + N * K + 8 * N + M * N * (1 if int8_out else 4)
                 + (M * N if name == "residual" else 0),
                 flops=2 * M * K * N, peak_flops=INT8_OPS)


def check_int8_matmul(device: str, card: str) -> tuple:
    """Both int8 kernels against their plain versions, exactly equal and
    bitwise equal over two launches: at the small odd shapes of
    ``INT8_EDGE_SHAPES`` (int8 and float32 out, ReLU on and off, and xq one
    byte off 16-byte alignment), then the requant kernel at stage 1's conv1
    (M = 100352, K = 256, N = 64) with int8 and float32 out, the residual
    kernel at stage 1's conv3 (M = 100352, K = 64, N = 256) with int8 out
    and at the last block (M = 1568, K = 512, N = 2048) with float32 out.
    Then the 17 shapes of one B = 32 forward, kernel against
    ``torch._int_mm``, both as CUDA-graph replays (device against device),
    with each tile shape the launcher can pick forced in turn (and bitwise
    equal to its choice). The returned entries time kernel and
    ``torch._int_mm`` alike, with CUDA events; the device times are
    printed."""
    s_out, s_id = 0.1, 0.03
    for M, K, N in INT8_EDGE_SHAPES:
        xq, wq, scale, bias, idq = int8_inputs(device, M, K, N, seed=60)
        buf = torch.empty(M * K + 1, dtype=torch.int8, device=device)
        buf[1:] = xq.reshape(-1)
        # The plain version always reads the aligned copy (cuBLASLt's own
        # alignment rules are not under test).
        for x in (xq, buf[1:].view(M, K)):
            # s_out = 0.004 puts many |y / s_out| past 200, the requant's
            # clamp-only branch.
            for so in (s_out, 0.004, None):
                for relu in (True, False):
                    fn = _int8_calls("requant", x, wq, scale, bias, idq, s_id, so, relu)[0]
                    ref = _int8_calls("requant", xq, wq, scale, bias, idq, s_id, so, relu)[1]
                    _int8_equal("requant", (M, K, N, relu), so, fn, ref)
                fn = _int8_calls("residual", x, wq, scale, bias, idq, s_id, so)[0]
                ref = _int8_calls("residual", xq, wq, scale, bias, idq, s_id, so)[1]
                want = _int8_equal("residual", (M, K, N), so, fn, ref)
                for tile, label in enumerate(INT8_TILES):
                    got = int8_launch(x, wq, scale, bias, idq, s_id, so, True, tile=tile)
                    if not torch.equal(got, want):
                        raise AssertionError(f"int8 residual ({M}, {K}, {N}) s_out={so} tile "
                                             f"{label}: differs from the plain version")
    print(f"[kernels] int8 kernels at {len(INT8_EDGE_SHAPES)} odd shapes "
          f"{list(INT8_EDGE_SHAPES)}, int8 out (s_out 0.1 and 0.004) and float32 out, relu on "
          f"and off, aligned and unaligned xq, the residual kernel with each tile forced: "
          f"equal to the plain versions, two launches bitwise equal")
    out = {}
    for name, M, K, N, so in (("requant", 100352, 256, 64, s_out),
                              ("requant", 100352, 256, 64, None),
                              ("residual", 100352, 64, 256, s_out),
                              ("residual", 1568, 512, 2048, None)):
        xq, wq, scale, bias, idq = int8_inputs(device, M, K, N, seed=61)
        fn, ref = _int8_calls(name, xq, wq, scale, bias, idq, s_id, so)
        got = _int8_equal(name, (M, K, N), so, fn, ref)
        share = ((got == 127) | (got == -127)).float().mean().item() if so else 0.0
        int_mm = lambda: torch._int_mm(xq, wq.t())  # noqa: E731
        ms = time_ms(fn, calls=20)
        dev = graph_ms(fn)
        plain_ms = time_ms(ref, calls=10)
        lib_ms = time_ms(int_mm, calls=20)
        lib_dev = graph_ms(int_mm)
        res = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev,
                   **_int8_bound(name, M, K, N, so is not None))
        print(f"[kernels] int8_matmul_{name} ({M}, {K}) x ({K}, {N}) "
              f"{'int8' if so else 'float32'} out: equal to the plain version, two launches "
              f"bitwise equal (saturated share {share:.4f}); kernel {ms:.4f} ms (device "
              f"{dev:.4f} ms, CUDA graph), plain {plain_ms:.4f} ms, torch._int_mm (no epilogue) "
              f"{lib_ms:.4f} ms (device {lib_dev:.4f} ms, CUDA graph), bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}; {res['bound_ms'] / dev:.3f} of it "
              f"reached) ({card})")
        out.setdefault(name, res)
    totals = {"kernel": 0.0, "bound": 0.0, "int_mm": 0.0, "divide": 0.0}
    for name, M, K, N, int8_out, launches in INT8_FORWARD_SHAPES:
        xq, wq, scale, bias, idq = int8_inputs(device, M, K, N, seed=62)
        so = s_out if int8_out else None
        fn, ref = _int8_calls(name, xq, wq, scale, bias, idq, s_id, so)
        _int8_equal(name, (M, K, N), so, fn, ref)
        got = fn()
        dev = graph_ms(fn)
        lib_dev = graph_ms(lambda: torch._int_mm(xq, wq.t()))
        b = _int8_bound(name, M, K, N, int8_out)
        totals["kernel"] += launches * dev
        totals["bound"] += launches * b["bound_ms"]
        totals["int_mm"] += launches * lib_dev
        variants = [(label, dict(tile=t)) for t, label in enumerate(INT8_TILES)]
        if int8_out:  # float32 out has no requant
            variants.append(("divide every output", dict(defines=INT8_DIVIDE_ALL)))
        forced = {}
        for label, kw in variants:
            call = lambda: int8_launch(  # noqa: E731
                xq, wq, scale, bias, idq if name == "residual" else None, s_id, so, True, **kw)
            if not torch.equal(call(), got):
                raise AssertionError(f"int8 {name} ({M}, {K}, {N}) {label}: differs from the "
                                     f"kernel")
            forced[label] = graph_ms(call)
        totals["divide"] += launches * forced.get("divide every output", dev)
        print(f"[kernels] int8 forward shape: {name} ({M}, {K}, {N}) "
              f"{'int8' if int8_out else 'float32'} out x{launches}: kernel device {dev:.4f} ms "
              f"(forced: {', '.join(f'{k} {v:.4f}' for k, v in forced.items())}), "
              f"torch._int_mm device {lib_dev:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {b['bound_ms'] / dev:.3f} of it "
              f"reached) ({card})")
        del xq, wq, scale, bias, idq
    n = sum(s[-1] for s in INT8_FORWARD_SHAPES)
    print(f"[kernels] int8 forward, {n} launches at {len(INT8_FORWARD_SHAPES)} shapes "
          f"(sum of launches x device ms, CUDA graphs): kernels {totals['kernel']:.4f} ms, "
          f"bound {totals['bound']:.4f} ms, torch._int_mm {totals['int_mm']:.4f} ms; with the "
          f"divide on every output {totals['divide']:.4f} ms ({card})")
    return out["requant"], out["residual"]


def extraction_variants() -> list:
    """(label, model_type, variant, compute_dtype, int8_conv1x1_pallas) of
    the extraction slice."""
    return [("vgg16 xla", "vgg16", "xla", "float32", False),
            ("resnet50 folded", "resnet50", "folded", "float32", False),
            ("resnet50 fused", "resnet50", "fused", "float32", False),
            ("resnet50 fused_s2d", "resnet50", "fused_s2d", "float32", False),
            ("resnet50 int8", "resnet50", "int8", "float32", False),
            ("resnet50 int8 + int8_conv1x1_pallas", "resnet50", "int8", "float32", True),
            ("resnet50 fused bf16", "resnet50", "fused", "bfloat16", False)]


def expected_cnn_launches(variant: str, flag: bool, forwards: int) -> dict:
    """Launches of the CNN kernels a run of ``forwards`` B = 32 forwards
    makes: 12 identity blocks a forward fused; 20 1x1 requant convs (16
    conv1, 4 downsample-block conv3) and 12 residual conv3 with the int8
    flag; none otherwise."""
    want = {"fused_bottleneck": 0, "matmul_bias_act": 0, "int8_matmul_requant": 0,
            "int8_matmul_residual_requant": 0}
    if variant in ("fused", "fused_s2d"):
        want["fused_bottleneck"] = 12 * forwards
    if variant == "int8" and flag:
        want["int8_matmul_requant"] = 20 * forwards
        want["int8_matmul_residual_requant"] = 12 * forwards
    return want


def profile_extract(fx: FeatureExtractor, batch: torch.Tensor, label: str, card: str) -> dict:
    """One-off, not a benchmark: torch.profiler over one B = 32 forward on
    frames already on the card: device busy, idle share, largest items."""
    from torch.profiler import ProfilerActivity, profile

    fx.extract_tensor(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fx.extract_tensor(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[profile] {label}: one B={len(batch)} forward (one-off, not a benchmark; {card}): "
          f"{wall_ms:.3f} ms wall under the profiler, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; top device time:")
    for e in rows[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy}


def run_extraction(card: str, device: str = "cuda", n_clips: int = 2, frames_per_video: int = 80,
                   size: int = 224, batch_size: int = 32, cpu_frames: int = 4) -> dict:
    """The feature-extraction slice: ``VideoFeatureExtractor`` over a
    directory of ``n_clips`` clips (seeded uint8 frames stand in for the
    decoder, which needs OpenCV) in every variant, launch counts read around
    each run, the first ``cpu_frames`` frames held against a CPU run with
    the plain versions, the .npy files and the dataset CSV checked, and one
    VGG16 clip captioned by the LSTM default predictor."""
    rng = np.random.default_rng(7)
    frames = {f"clip{i}": rng.integers(0, 256, (frames_per_video, size, size, 3), np.uint8)
              for i in range(n_clips)}
    decode = video_mod.extract_frames
    video_mod.extract_frames = lambda path, *a, **k: frames[Path(path).stem]
    out = {"launches": {}, "forward_ms": {}}
    feats = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            videos = Path(tmp) / "videos"
            videos.mkdir()
            for stem in frames:
                (videos / f"{stem}.mp4").write_bytes(b"")
            (Path(tmp) / "captions.txt").write_text(
                "".join(f"caption of {stem}\n" for stem in sorted(frames)))
            forwards = n_clips * -(-frames_per_video // batch_size)
            for label, model_type, variant, dtype, flag in extraction_variants():
                config = Config()
                config.kernels.int8_conv1x1_pallas = flag
                t0 = time.perf_counter()
                vfe = cli_preprocess.VideoFeatureExtractor(
                    model_type, batch_size=batch_size, frames_per_video=frames_per_video,
                    img_size=(size, size), allow_random_init=True, num_workers=2,
                    variant=variant, compute_dtype=dtype, device=device, config=config)
                out_dir = Path(tmp) / label.replace(" ", "_")
                reset_launch_counts()
                t1 = time.perf_counter()
                written = vfe.process_video_directory(videos, out_dir, overwrite=True)
                sync(device)
                n = launch_counts()
                wall = time.perf_counter() - t1
                want = expected_cnn_launches(variant, flag, forwards)
                got = {k: n[k] for k in want}
                out["launches"][label] = got
                if device == "cuda" and got != want:
                    raise AssertionError(f"{label}: CNN kernel launches {got}, want {want}")
                feats[label] = {p.stem: np.load(p) for p in written}
                F_dim = vfe.backbone.feature_dim
                for stem, f in feats[label].items():
                    if f.shape != (frames_per_video, F_dim) or not np.isfinite(f).all():
                        raise AssertionError(f"{label} {stem}: features {f.shape}, finite "
                                             f"{np.isfinite(f).all()}")
                batch = torch.from_numpy(frames["clip0"][:batch_size]).to(device)
                if device == "cuda":
                    out["forward_ms"][label] = time_ms(lambda: vfe.backbone.extract_tensor(batch),
                                                       calls=3)
                    if label in ("resnet50 fused", "resnet50 int8 + int8_conv1x1_pallas",
                                 "resnet50 fused bf16"):
                        out.setdefault("profiles", {})[label] = profile_extract(
                            vfe.backbone, batch, label, card)
                # The first frames again on the CPU with the plain versions and
                # the same weights (an int8 run loads the card's calibration).
                kw = {}
                if variant == "int8":
                    kw["weights_path"] = Path(tmp) / f"{out_dir.name}.vcw.npz"
                    vfe.backbone.save_int8(kw["weights_path"])
                else:
                    kw["allow_random_init"] = True
                cpu = FeatureExtractor(model_type, config, batch_size=batch_size, variant=variant,
                                       compute_dtype="float32" if dtype == "bfloat16" else dtype,
                                       device="cpu", **kw)
                ref = cpu.extract(frames["clip0"][:cpu_frames])
                card_f = feats[label]["clip0"][:cpu_frames]
                if variant == "int8":
                    err = feature_error(ref, card_f)
                    f32 = feats["resnet50 folded"]["clip0"][:cpu_frames]
                    vs_f32 = feature_error(f32, card_f)
                    ok = (err["mean_cosine"] > FEAT_INT8_COS
                          and vs_f32["mean_cosine"] > INT8_VS_F32[0]
                          and vs_f32["rel_l2"] < INT8_VS_F32[1])
                    what = f"vs CPU int8 {err}; vs card folded float32 {vs_f32}"
                elif dtype == "bfloat16":
                    err = float(np.mean(np.abs(card_f - ref)) / np.mean(np.abs(ref)))
                    ok, what = err < FEAT_BF16_MEAN_REL, f"mean |d| / mean |f32 CPU| {err:.4g}"
                else:
                    err = float(np.linalg.norm(card_f - ref) / np.linalg.norm(ref))
                    ok, what = err <= FEAT_F32_REL_L2, f"relative L2 vs CPU {err:.3g}"
                print(f"[extract] {label}: {len(written)} clips x ({frames_per_video}, {F_dim}) "
                      f"in {wall:.2f} s wall on {device} (built in {t1 - t0:.1f} s; one call, not "
                      f"a benchmark; {card}); launches {got}; first {cpu_frames} frames {what}; "
                      f"one B={batch_size} forward "
                      f"{out['forward_ms'].get(label, float('nan')):.3f} ms (CUDA events)")
                if not ok:
                    raise AssertionError(f"{label}: card vs CPU out of tolerance: {what}")
            if device == "cuda":
                fused, folded = (out["forward_ms"][f"resnet50 {v}"] for v in ("fused", "folded"))
                print(f"[extract] one B={batch_size} ResNet50 forward in this run: fused "
                      f"{fused:.3f} ms, folded {folded:.3f} ms (fused / folded "
                      f"{fused / folded:.3f}; {card})")
            vgg_dir = Path(tmp) / "vgg16_xla"
            csv_path = Path(tmp) / "dataset.csv"
            cli_preprocess.create_dataset_csv(videos, vgg_dir, Path(tmp) / "captions.txt",
                                              csv_path)
            with open(csv_path, newline="") as f:
                rows = list(csv.DictReader(f))
            if len(rows) != n_clips or not all(r["caption"] for r in rows):
                raise AssertionError(f"dataset CSV: {rows}")
            # The new stage joined to the served path: one VGG16 clip's .npy
            # captioned by the LSTM default predictor.
            pkg = smoke_package(tmp, Config())
            predictor = VideoCaptionPredictor(pkg, device=device)
            res = predictor.predict_batch([np.load(vgg_dir / "clip0.npy")], method="beam",
                                          beam_size=5)[0]
            _check_caption(res, Config().model.vocab_size, "VGG16 clip caption")
            print(f"[extract] dataset CSV {len(rows)} rows with captions; the LSTM default "
                  f"predictor captioned clip0's VGG16 features: {res['caption'][:60]!r}...")
    finally:
        video_mod.extract_frames = decode
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


def fused_config() -> Config:
    """``Config()`` with the fused decode step: the attention, LSTM-cell and
    fused vocabulary kernels on."""
    config = Config()
    for flag in ("use_pallas_attention", "use_pallas_lstm", "use_fused_vocab_topk"):
        setattr(config.kernels, flag, True)
    return config


def transformer_config() -> Config:
    """``Config()`` with the transformer family: d_model 512, 2 + 2 blocks,
    8 heads, MLP 2048, V = 10000, 80 frames; every kernel flag at its
    default (the beam step's top-k through ``topk2d_lse``)."""
    config = Config()
    config.model.architecture = "transformer"
    config.validate()
    return config


def fused_transformer_config() -> Config:
    """The transformer with ``kernels.transformer_fused_beam_attn``: every
    beam step runs ``beam_self_attention`` and ``beam_cross_attention`` once
    per decoder block."""
    config = transformer_config()
    config.kernels.transformer_fused_beam_attn = True
    return config


def expected_launches(config: Config, batches: int, steps: int = 20) -> dict:
    """Fewest launches of each kernel the served requests must make: one
    greedy decode and ``batches - 1`` beam decodes of ``steps`` steps."""
    k = config.kernels
    if config.model.architecture == "transformer":
        want = {}
        if k.transformer_fused_beam_attn:
            per_batch = config.model.transformer_decoder_layers * steps
            want["beam_self_attention"] = per_batch * (batches - 1)
            want["beam_cross_attention"] = per_batch * (batches - 1)
        if k.use_pallas_topk:
            want["topk2d_lse"] = steps * (batches - 1)
        return want
    layers = config.model.decoder_num_layers
    want = {"lstm_seq": config.model.encoder_num_layers * batches}
    if k.use_pallas_lstm:
        want["lstm_cell_fused"] = layers * steps * batches
    if k.use_pallas_attention:
        want["bahdanau_attend"] = steps
    if k.use_fused_vocab_topk:
        want["vocab_topk_lse"] = steps * (batches - 1)
    elif k.use_pallas_topk:
        want["topk2d_lse"] = steps * (batches - 1)
    return want


def describe(config: Config) -> str:
    k, m = config.kernels, config.model
    if m.architecture == "transformer":
        return f"transformer, {'fused' if k.transformer_fused_beam_attn else 'default'}"
    attention = ("no attention" if not m.use_attention else
                 f"luong {m.luong_score}" if m.attention_type == "luong" else
                 f"multihead x{m.attention_num_heads}" if m.attention_type == "multihead" else "")
    return f"lstm{' ' + attention if attention else ''}, {'fused' if k.use_pallas_lstm else 'default'}"


GATE = beam_mod.fused_vocab_eligible


def gate_as_on_card(config, device, B, K, V):
    """The fused-vocabulary gate evaluated as if the tensors were on the
    card, so a CPU reference run takes the card's branch."""
    return GATE(config, torch.device("cuda"), B, K, V)


def profile_decode(predictor: VideoCaptionPredictor, batch: list, card: str) -> dict:
    """One-off, not a benchmark: encode + beam-5 on features already on the
    card, CUDA-event time (median of 3) and torch.profiler's device time of
    one more."""
    from torch.profiler import ProfilerActivity, profile

    feats = torch.from_numpy(np.stack([predictor._prepare_features(c) for c in batch])).cuda()
    vocab, config, model = predictor.vocabulary, predictor.config, predictor.model

    @torch.inference_mode()
    def window():
        enc, final, mask = encode(model, config, feats)
        return beam_mod.beam_search_generate(model, config, enc, final, vocab.start_idx,
                                             vocab.end_idx, 20, mask, beam_size=5)

    window_ms = time_ms(window, calls=1, runs=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        window()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    dtype = next(model.parameters()).dtype
    label = describe(config) + ("" if dtype == torch.float32 else f", {dtype}")
    print(f"[profile] {label}: encode + beam-5 at B={len(batch)} on the card "
          f"(one-off, not a benchmark; {card}): {window_ms:.3f} ms from CUDA events; device "
          f"busy {busy:.3f} ms "
          f"in the profiled window, idle share {1 - busy / window_ms:.3f}; top device time:")
    for e in rows[:14]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return {"window_ms": window_ms, "device_busy_ms": busy}


def run_slice(device: str, config: Config, clips: np.ndarray, cpu_clips: int,
              card: str) -> dict:
    V = config.model.vocab_size
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pkg = smoke_package(tmp, config)
        predictor = VideoCaptionPredictor(pkg, device=device)
        print(f"[slice] {describe(config)}: package written and loaded on {device} in "
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

        # The configuration's kernels must have carried the served requests;
        # the fused vocabulary kernel replaces topk2d_lse.
        n = out["launches"]
        want = expected_launches(config, metrics["batches"])
        low = {name: (n[name], m) for name, m in want.items() if n[name] < m}
        if device == "cuda" and (low or (config.kernels.use_fused_vocab_topk
                                         and n["topk2d_lse"])):
            raise AssertionError(f"kernel launch counts (got, fewest) too low: {low}, or "
                                 f"topk2d_lse ran beside the fused vocabulary kernel: {n}")

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
        if device == "cuda":
            out["profile"] = profile_decode(predictor, batch, card)

        cpu_config = Config.from_dict(predictor.config.to_dict())
        cpu_config.kernels.interpret = True  # plain versions, same contract
        cpu_pred = VideoCaptionPredictor(pkg, config=cpu_config, device="cpu")
        beam_mod.fused_vocab_eligible = gate_as_on_card
        try:
            cpu_results = cpu_pred.predict_batch(batch[:cpu_clips], method="beam", beam_size=5)
        finally:
            beam_mod.fused_vocab_eligible = GATE
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


def interpret_config(config: Config) -> Config:
    """A copy of ``config`` whose CPU runs take the kernels' plain versions
    under the kernels' contracts (``kernels.interpret``)."""
    config = Config.from_dict(config.to_dict())
    config.kernels.interpret = True
    return config


def agreement(results: list, reference: list) -> float:
    """Share of clips whose tokens equal the reference run's."""
    same = [a["tokens"] == b["tokens"] for a, b in zip(results, reference, strict=True)]
    return sum(same) / len(same)


def run_training(card: str, config: Config, device: str = "cuda", n_clips: int = 96) -> dict:
    """The training slice through ``cli.train.main``: two epochs on
    synthetic clips, then the inference package it wrote is loaded by
    ``VideoCaptionPredictor`` on ``device`` and captions 8 clips with beam
    5, held against the CPU run with the plain versions."""
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
            if config.model.architecture == "transformer":
                # Its teacher forcing and greedy validation launch no kernel.
                bad = any(n.values())
            else:
                bad = (n["lstm_seq_train_fwd"] < 2 * steps or n["lstm_seq_train_bwd"] < 2 * steps
                       or n["lstm_seq"] == 0)
            if device == "cuda" and bad:
                raise AssertionError(f"training launch counts for {steps} steps: {n}")
            pkg = "ck/model_for_inference.pth"
            predictor = VideoCaptionPredictor(pkg, device=device)
            clips = [np.load(Path(tmp) / f"clip{i:03d}.npy") for i in range(8)]
            results = predictor.predict_batch(clips, method="beam", beam_size=5)
            for i, r in enumerate(results):
                if not isinstance(r["caption"], str):
                    raise AssertionError(f"trained package, clip {i}: {str(r)[:200]}")
                if not all(0 <= t < config.model.vocab_size for t in r["tokens"]):
                    raise AssertionError(f"trained package, clip {i}: token out of range")
            cpu_results = VideoCaptionPredictor(pkg, config=interpret_config(predictor.config),
                                                device="cpu").predict_batch(clips, method="beam",
                                                                            beam_size=5)
            out["agreement"] = agreement(results, cpu_results)
            print(f"[train] model_for_inference.pth loaded on {predictor.device}, 8 clips "
                  f"captioned with beam 5; tokens, card vs CPU plain versions: agreement "
                  f"{out['agreement']:.4f}")
            if out["agreement"] < MIN_CLIP_AGREEMENT:
                raise AssertionError(f"trained package: clip agreement {out['agreement']}")
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
    m = config.model
    m.encoder_dropout = m.decoder_dropout = m.transformer_dropout = 0.0
    batch = _step_batch(config, B, seed=5)
    t0 = time.perf_counter()
    reset_launch_counts()
    loss_gpu, g_gpu = _loss_and_grads(config, device, batch)
    sync(device)
    launches = launch_counts()
    with recurrence_gate_as_on_card():
        loss_cpu, g_cpu = _loss_and_grads(interpret_config(config), "cpu", batch)
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
    return {"loss_rel": loss_rel, "grad_rel": grad_rel[worst], "launches": launches}


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
    print(f"[profile] one training step at B={B}, {describe(trainer.config)} (one-off, not a "
          f"benchmark; {card}): {step_ms:.2f} ms per step from CUDA events; device busy "
          f"{busy:.2f} ms in the profiled step (idle share {1 - busy / step_ms:.3f}), "
          f"{ours:.2f} ms of it in the lstm_seq_train kernels; top device time:")
    for e in rows[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return {"step_ms": step_ms, "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "lstm_kernels_ms": ours}


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


@contextlib.contextmanager
def recurrence_gate_as_on_card():
    """The encoder's recurrence-kernel gate evaluated as if the tensors were
    on the card (the card's kernel limit), so a CPU reference run takes the
    card's branch: the plain versions within the kernels' domain, lstm_scan
    outside it."""
    gate = encoder_mod.lstm_seq_eligible
    encoder_mod.lstm_seq_eligible = (
        lambda H, dtype, device, train=False: gate(H, dtype, torch.device("cuda"), train))
    try:
        yield
    finally:
        encoder_mod.lstm_seq_eligible = gate


def run_transformer_training(card: str, device: str = "cuda", n_clips: int = 96) -> dict:
    """The transformer's training slice at full width, dropout at its
    default: ``cli.train`` for 2 epochs (its package served on the card and
    held against the CPU run), the step held against the CPU, 10 steps that
    must lower the loss, and the one-off step profiles."""
    config = transformer_config()
    t0 = time.perf_counter()
    out = {"train": run_training(card, config, device, n_clips)}
    out["parity"] = check_step_parity(card, config, device)
    if device == "cuda" and any(out["parity"]["launches"].values()):
        raise AssertionError(f"transformer step launched kernels: {out['parity']['launches']}")
    out["profile"] = check_overfit_and_profile(card, config, device)
    print(f"[train] transformer phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def encoder_log():
    """The encoder's log lines while the block runs."""
    handler, logger = _Records(), logging.getLogger(encoder_mod.__name__)
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield handler.lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def counted(device: str, what: str, want: dict, fn):
    """Run ``fn`` with the launch counters zeroed just before and read just
    after; on the card the kernels in ``want`` must have launched exactly
    that often. Returns (fn's result, the counts)."""
    reset_launch_counts()
    result = fn()
    sync(device)
    n = launch_counts()
    got = {k: n[k] for k in want}
    if device == "cuda" and got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return result, n


def encode_launches(config: Config, encodes: int, beams: int, steps: int = 20) -> dict:
    """The launches ``encodes`` encodes and ``beams`` beam searches of
    ``steps`` steps make under ``config``'s default kernel flags."""
    return {"lstm_seq": config.model.encoder_num_layers * encodes, "topk2d_lse": steps * beams}


def _entry_point_calls(device: str, tmp: Path, work: Path, pkg: str, frames: dict,
                       config: Config) -> dict:
    """The entry points' calls on ``device``, their files in ``work``; returns
    the outputs to compare and the launches of each call. What the CLIs
    print goes to a buffer (the JSON files hold their results)."""
    work.mkdir()
    common = ["--model-path", pkg, "--device", device, "--log-level", "WARNING"]
    out, launches = {}, {}

    def run(name, want, fn):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out[name], launches[name] = counted(device, name, want, fn)
        print(f"[entry] {name} on {device}: {time.perf_counter() - t0:.2f} s wall (one call, "
              f"not a benchmark); launches { {k: launches[name][k] for k in want} }")

    def predict(name, want, *argv):
        path = work / f"{name}.json"
        run(name, want, lambda: cli_predict.main([*common, *argv, "--output", str(path)]))
        out[name] = json.loads(path.read_text())

    beam = ["--method", "beam", "--beam-size", "5"]
    predict("single features", encode_launches(config, 1, 1), *beam, "single", "--video-path",
            "clip0.mp4", "--features-path", str(tmp / "clip00.npy"))
    predict("single video, cnn", encode_launches(config, 1, 1), "--feature-mode", "cnn",
            "--allow-random-cnn-init", *beam, "single", "--video-path", str(tmp / "clip0.mp4"))
    videos = [tmp / f"clip{i}.mp4" for i in range(len(frames))]
    listing = work / "videos.txt"
    listing.write_text("\n".join(str(v) for v in videos[:2] + [tmp / "broken.mp4"] + videos[2:]))
    predict("batch videos", encode_launches(config, 1, 1), *beam, "batch", "--video-list",
            str(listing), "--batch-size", "8", "--captions-file", str(work / "captions.txt"))
    predict("multiple", encode_launches(config, 1, 1), "--method", "beam", "--beam-size", "10",
            "multiple", "--video-path", "clip0.mp4", "--features-path", str(tmp / "clip01.npy"),
            "--num-captions", "5")
    run("evaluate files", {"lstm_seq": 0, "topk2d_lse": 0}, lambda: cli_evaluate.main(
        ["--predictions", str(work / "captions.txt"), "--references", str(tmp / "refs.txt"),
         "--log-level", "WARNING"]))
    run("evaluate dataset", encode_launches(config, 2, 2), lambda: cli_evaluate.main(
        ["--model-path", pkg, "--data-file", str(tmp / "dataset.csv"), "--split", "all",
         "--batch-size", "8", "--device", device, "--log-level", "WARNING"]))
    run("import_reference", {"lstm_seq": 0, "topk2d_lse": 0}, lambda: cli_import_reference.main(
        ["--input", str(tmp / "upstream_state.pth"), "--output-dir", str(work / "imported"),
         "--vocabulary", str(tmp / "vocabulary.json"), "--config", str(tmp / "base.json"),
         "--log-level", "WARNING"]))
    imported = VideoCaptionPredictor(out["import_reference"]["output"], device=device)
    clips = [np.load(tmp / f"clip{i:02d}.npy") for i in range(4)]
    run("imported package, beam-5 x 4", encode_launches(config, 1, 1),
        lambda: imported.predict_batch(clips, method="beam", beam_size=5))
    return {"out": out, "launches": launches}


def run_entry_points(card: str, device: str = "cuda", n_clips: int = 16, n_videos: int = 4,
                     frames_per_video: int = 80, size: int = 224) -> dict:
    """``cli.predict`` (single from features and from a video, batch,
    multiple), ``cli.evaluate`` (file and dataset modes) and
    ``cli.import_reference`` on the LSTM default at full width, on
    ``device`` and then on the CPU with the plain versions (the package's
    ``kernels.interpret``); seeded frames stand in for the OpenCV decoder
    and an unreadable video raises in its place. Every token list, caption
    and score must be the CPU run's."""
    config = Config()
    config.kernels.interpret = True  # the CPU run's contract; the card runs its kernels
    rng = np.random.default_rng(11)
    frames = {f"clip{i}": rng.integers(0, 256, (frames_per_video, size, size, 3), np.uint8)
              for i in range(n_videos)}

    def decode(path, *a, **k):
        stem = Path(path).stem
        if stem not in frames:
            raise ValueError(f"Cannot open video: {path}")
        return frames[stem]

    real_decode = video_mod.extract_frames
    video_mod.extract_frames = decode
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            pkg = smoke_package(str(tmp), config)
            V = config.model.vocab_size
            lines = ["video_id,video_path,feature_path,caption"]
            for i in range(n_clips):
                np.save(tmp / f"clip{i:02d}.npy", rng.standard_normal(
                    (frames_per_video, config.model.cnn_feature_dim), dtype=np.float32))
                for j in range(1 + i % 3):
                    words = " ".join(f"w{w}" for w in rng.integers(4, V, 6))
                    lines.append(f"vid{i:02d},,{tmp / f'clip{i:02d}.npy'},{words}")
            (tmp / "dataset.csv").write_text("\n".join(lines) + "\n")
            (tmp / "refs.txt").write_text("".join(f"w{4 + i} w{5 + i} w{6 + i}\n"
                                                  for i in range(n_videos + 1)))
            # A synthetic upstream artifact: a raw state dict under the
            # upstream names, its vocabulary.json and a config to size it.
            params = init_params_numpy(config, V, seed=3)
            torch.save(state_dict_from_jax_params(params, config), tmp / "upstream_state.pth")
            vocabulary_from_package(load_model_for_inference(pkg), config).save(
                tmp / "vocabulary.json")
            (tmp / "base.json").write_text(json.dumps(config.to_dict()))
            on_device = _entry_point_calls(device, tmp, tmp / "on_device", pkg, frames, config)
            on_cpu = _entry_point_calls("cpu", tmp, tmp / "on_cpu", pkg, frames, config)
    finally:
        video_mod.extract_frames = real_decode
    got, want = on_device["out"], on_cpu["out"]
    batch = got["batch videos"]["results"]
    if (len(batch) != n_videos + 1 or [i for i, r in enumerate(batch) if "error" in r] != [2]
            or "broken" not in batch[2]["video_path"]):
        raise AssertionError(f"batch: the unreadable video is not an error entry in its place: "
                             f"{got['batch videos']['results']}")
    if len(got["multiple"]["captions"]) != 5:
        raise AssertionError(f"multiple: {len(got['multiple']['captions'])} captions, want 5")
    for name in got:
        a, b = got[name], want[name]
        if name == "multiple":  # scores are float32 sums: within 1e-4
            same = (all(x["tokens"] == y["tokens"] and abs(x["score"] - y["score"]) <= 1e-4
                        * max(1.0, abs(y["score"]))
                        for x, y in zip(a["captions"], b["captions"], strict=True)))
        elif name == "imported package, beam-5 x 4":
            same = [r["tokens"] for r in a] == [r["tokens"] for r in b]
        elif name == "import_reference":
            same = True
        else:
            same = a == b
        if not same:
            raise AssertionError(f"{name}: card and CPU runs differ:\n{str(a)[:600]}\n"
                                 f"{str(b)[:600]}")
    print(f"[entry] every output equal to the CPU run (plain versions): single "
          f"{got['single features']['caption'][:40]!r}..., batch with one error entry in place, "
          f"5 captions from beam 10, evaluate dataset over {got['evaluate dataset']['num_videos']} "
          f"videos, the imported package served; {time.perf_counter() - t0:.1f} s wall in all "
          f"({card})")
    return {"launches": {k: sum(n[k] for n in on_device["launches"].values())
                         for k in launch_counts()}}


def run_wide_encoder(card: str, clips: np.ndarray, device: str = "cuda") -> dict:
    """``encoder_hidden_dim = 1024``, past the recurrence kernels' limit:
    8 clips with beam 5 and one training step on ``device``, the encoder's
    log naming the gate, no ``lstm_seq*`` launch, tokens equal to the CPU
    run (the gate evaluated as on the card) and the loss within
    STEP_LOSS_RTOL."""
    config = Config()
    config.model.encoder_hidden_dim = 1024
    config.validate()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, config)
        with encoder_log() as lines:
            predictor = VideoCaptionPredictor(pkg, device=device)
            results, served = counted(device, "H=1024 beam-5 x 8",
                                      {"lstm_seq": 0, "topk2d_lse": 20},
                                 lambda: predictor.predict_batch(list(clips[:8]), method="beam",
                                                                 beam_size=5))
        with recurrence_gate_as_on_card():
            cpu = VideoCaptionPredictor(pkg, config=interpret_config(config),
                                        device="cpu").predict_batch(list(clips[:8]),
                                                                    method="beam", beam_size=5)
    share = agreement(results, cpu)
    gate_lines = [line for line in lines if "lstm_seq_eligible" in line]
    print(f"[wide] encoder H=1024 served 8 clips on {device}: launches "
          f"{ {k: served[k] for k in ('lstm_seq', 'topk2d_lse')} }; tokens, card vs CPU: "
          f"agreement {share:.4f}; the encoder's log: {gate_lines}")
    if share < 1.0 or (device == "cuda" and not any(
            "H=1024" in line and "lstm_scan" in line for line in gate_lines)):
        raise AssertionError(f"wide encoder: agreement {share}, log {lines}")
    with encoder_log() as lines:
        parity = check_step_parity(card, config, device)
    n = parity["launches"]
    print(f"[wide] one training step at H=1024: launches "
          f"{ {k: n[k] for k in ('lstm_seq', 'lstm_seq_train_fwd', 'lstm_seq_train_bwd')} }; "
          f"the encoder's log: "
          f"{[line for line in lines if 'lstm_seq_eligible' in line]}; "
          f"{time.perf_counter() - t0:.1f} s wall in the phase ({card})")
    if device == "cuda" and (n["lstm_seq_train_fwd"] or n["lstm_seq_train_bwd"] or n["lstm_seq"]
                             or not any("lstm_seq_train limit" in line and "lstm_scan" in line
                                        for line in lines)):
        raise AssertionError(f"wide encoder training step: launches {n}, log {lines}")
    return {"launches": {k: served[k] + n[k] for k in n}, "agreement": share,
            "loss_rel": parity["loss_rel"]}

def options_config(attention: str, score: str = "general", use_attention: bool = True,
                   fused: bool = False) -> Config:
    """``Config()`` (or ``fused_config()``) with another decoder option:
    Luong attention with ``score``, multi-head (8 heads) or no attention."""
    config = fused_config() if fused else Config()
    config.model.attention_type, config.model.luong_score = attention, score
    config.model.use_attention = use_attention
    config.validate()
    return config


DECODER_OPTIONS = (("luong", "dot", True), ("luong", "general", True), ("luong", "concat", True),
                   ("multihead", "general", True), ("bahdanau", "general", False))


def add_counts(total: dict, n: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in n.items()}


def run_decoder_options(card: str, clips: np.ndarray, device: str = "cuda",
                        cpu_clips: int = 8) -> dict:
    """The LSTM decoder's other options at ``Config()`` widths: Luong dot,
    general and concat, multi-head with 8 heads and no attention, each
    served beam-5 on a B = 128 batch (2 ``lstm_seq`` and 20 ``topk2d_lse``
    launches exactly), profiled once, and its first ``cpu_clips`` clips held
    against the CPU run with the plain versions; then Luong general under
    the fused decode step (40 ``lstm_cell``, 20 ``vocab_topk_lse``, no
    ``bahdanau_attend`` and no ``topk2d_lse``), one ``/caption`` and one
    ``/caption_batch`` of 8 through the server, and one training step of
    Luong general and of multi-head against the CPU (check_step_parity)."""
    out = {"launches": {}, "agreement": {}, "profile": {}}
    batch = list(clips)
    configs = [options_config(*o) for o in DECODER_OPTIONS]
    configs.append(options_config("luong", "general", fused=True))
    for config in configs:
        label = describe(config)
        L = config.model.encoder_num_layers
        want = {"lstm_seq": L, "topk2d_lse": 20}
        if config.kernels.use_pallas_lstm:
            want = {"lstm_seq": L, "lstm_cell_fused": config.model.decoder_num_layers * 20,
                    "vocab_topk_lse": 20, "bahdanau_attend": 0, "topk2d_lse": 0}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            pkg = smoke_package(tmp, config)
            predictor = VideoCaptionPredictor(pkg, device=device)
            predictor.predict_batch(batch[:8], method="beam", beam_size=5)  # warm
            results, n = counted(device, f"{label} beam-5 B={len(batch)}", want,
                                 lambda: predictor.predict_batch(batch, method="beam",
                                                                 beam_size=5))
            out["launches"] = add_counts(out["launches"], n)
            for i, r in enumerate(results):
                _check_caption(r, config.model.vocab_size, f"{label} clip {i}")
            if device == "cuda":
                out["profile"][label] = profile_decode(predictor, batch, card)
            if config.kernels.use_pallas_lstm:
                server = CaptionServer(predictor, port=0, max_batch=8, max_wait_ms=200.0)
                server.start()
                try:
                    feats = [np.round(c, 3).tolist() for c in clips[:8]]
                    one = _http(server.port, "/caption",
                                {"features": feats[0], "method": "beam", "beam_size": 5})
                    many = _http(server.port, "/caption_batch",
                                 {"items": [{"features": f} for f in feats], "method": "beam",
                                  "beam_size": 5})
                finally:
                    server.close()
                _check_caption(one, config.model.vocab_size, f"{label} /caption")
                if len(many["results"]) != 8:
                    raise AssertionError(f"{label} /caption_batch: {len(many['results'])} results")
                for i, r in enumerate(many["results"]):
                    _check_caption(r, config.model.vocab_size, f"{label} /caption_batch {i}")
                print(f"[options] {label}: served /caption {one['caption'][:40]!r}... and a "
                      f"/caption_batch of 8")
            beam_mod.fused_vocab_eligible = gate_as_on_card
            try:
                cpu = VideoCaptionPredictor(pkg, config=interpret_config(config),
                                            device="cpu").predict_batch(
                    batch[:cpu_clips], method="beam", beam_size=5)
            finally:
                beam_mod.fused_vocab_eligible = GATE
        share = agreement(results[:cpu_clips], cpu)
        out["agreement"][label] = share
        print(f"[options] {label}: beam-5 B={len(batch)} on {device}, launches "
              f"{ {k: n[k] for k in want} }; tokens, card vs CPU plain versions, first "
              f"{cpu_clips} clips: agreement {share:.4f}; {time.perf_counter() - t0:.1f} s "
              f"in the configuration ({card})")
        if share < MIN_CLIP_AGREEMENT:
            raise AssertionError(f"{label}: clip agreement {share} < {MIN_CLIP_AGREEMENT}")
    for config in (options_config("luong", "general"), options_config("multihead")):
        parity = check_step_parity(card, config, device)
        out["launches"] = add_counts(out["launches"], parity["launches"])
    return out


class HandedNoise:
    """Stands in for ``sampling.gumbel_noise``: step t of a decode gets the
    first rows of ``noise[t]``, whatever the batch's bucket."""

    def __init__(self, noise: list):
        self.noise, self.calls = noise, 0

    def __call__(self, shape, generator, device):
        t = self.calls % len(self.noise)
        self.calls += 1
        return self.noise[t][:shape[0]].to(device)


def run_sampling(card: str, clips: np.ndarray, device: str = "cuda", cpu_clips: int = 8,
                 temperature: float = 0.7) -> dict:
    """Ancestral sampling on ``Config()`` at B = 128 through
    ``predict_batch(method="sample")``: for top_k 0 and 10, Gumbel noise
    drawn once on the CPU from a seeded generator and handed to the card's
    run and to the CPU run with the plain versions (the first ``cpu_clips``
    clips' tokens equal, log-probabilities within SAMPLE_LOGP_ATOL); then
    the default path, the predictor's ``torch.Generator`` on the card: valid
    tokens, and two predictors with the same seed bitwise equal."""
    config = Config()
    V, B = config.model.vocab_size, len(clips)
    out = {"launches": {}}
    batch = list(clips)
    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, config)
        predictor = VideoCaptionPredictor(pkg, device=device)
        cpu_pred = VideoCaptionPredictor(pkg, config=interpret_config(config), device="cpu")
        real_noise = sampling_mod.gumbel_noise
        try:
            for top_k in (0, 10):
                gen = torch.Generator().manual_seed(11 + top_k)
                noise = [real_noise((B, V), gen, torch.device("cpu")) for _ in range(20)]
                predictor.sample_top_k = cpu_pred.sample_top_k = top_k
                sampling_mod.gumbel_noise = HandedNoise(noise)
                got, n = counted(device, f"sample top_k={top_k} B={B}",
                                 {"lstm_seq": config.model.encoder_num_layers, "topk2d_lse": 0},
                                 lambda: predictor._run_generation(
                                     np.stack(batch), "sample", 20, 5, 1.0, temperature))
                out["launches"] = add_counts(out["launches"], n)
                sampling_mod.gumbel_noise = HandedNoise(noise)
                want = cpu_pred._run_generation(np.stack(batch[:cpu_clips]), "sample", 20, 5,
                                                1.0, temperature)
                same = bool((got["generated_tokens"][:cpu_clips]
                             == want["generated_tokens"]).all())
                logp_err = float(np.abs(got["logprobs"][:cpu_clips] - want["logprobs"]).max())
                print(f"[sample] top_k={top_k} T={temperature} B={B} on {device}, noise handed "
                      f"in: first {cpu_clips} clips' tokens equal to the CPU run: {same}; "
                      f"logprob max err {logp_err:.3g} (tol {SAMPLE_LOGP_ATOL}); launches "
                      f"{ {k: n[k] for k in ('lstm_seq', 'topk2d_lse')} }")
                if not same or logp_err > SAMPLE_LOGP_ATOL:
                    raise AssertionError(f"sampling top_k={top_k}: tokens equal {same}, "
                                         f"logprob err {logp_err}")
        finally:
            sampling_mod.gumbel_noise = real_noise
        runs = []
        for _ in range(2):
            pred = VideoCaptionPredictor(pkg, device=device, sample_seed=5)
            res, n = counted(device, "sample, the predictor's generator",
                             {"lstm_seq": config.model.encoder_num_layers},
                             lambda: pred.predict_batch(batch, method="sample",
                                                        temperature=temperature))
            out["launches"] = add_counts(out["launches"], n)
            runs.append(res)
        for i, r in enumerate(runs[0]):
            _check_caption(r, V, f"sample clip {i}")
        if [r["tokens"] for r in runs[0]] != [r["tokens"] for r in runs[1]]:
            raise AssertionError("sampling: two predictors with the same seed disagree")
        print(f"[sample] default path: generator on {pred._sample_generator.device}, "
              f"{len(runs[0])} clips valid, two calls with the same seed bitwise equal")
    return out


def first_divergence(a: list, b: list) -> list:
    """Per clip whose tokens differ, the first position where they do."""
    return [next(i for i, (x, y) in enumerate(zip(r["tokens"], s["tokens"])) if x != y)
            for r, s in zip(a, b) if r["tokens"] != s["tokens"]]


def run_bf16_serving(card: str, clips: np.ndarray, device: str = "cuda",
                     cpu_clips: int = 16) -> dict:
    """``Config()`` served with ``compute_dtype="bfloat16"`` (the package of
    smoke_package: projection sharpened x3, END suppressed, the protocol of
    benchmarks/bf16_parity_gate.py), greedy and beam-5 at B = 128: clip
    agreement with the CPU port's bfloat16 run on the first ``cpu_clips``
    clips (greedy gated at MIN_BF16_GREEDY_AGREEMENT, beam recorded), with
    the card's float32 run on all of them, first-divergence positions, and
    one encode + beam-5 timed and profiled beside float32."""
    config = Config()
    L = config.model.encoder_num_layers
    out = {"launches": {}, "agreement": {}, "profile": {}}
    batch = list(clips)
    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, config)
        p16 = VideoCaptionPredictor(pkg, device=device, compute_dtype="bfloat16")
        p32 = VideoCaptionPredictor(pkg, device=device)
        cpu16 = VideoCaptionPredictor(pkg, config=interpret_config(config), device="cpu",
                                      compute_dtype="bfloat16")
        for method, want in (("greedy", {"lstm_seq": L, "topk2d_lse": 0}),
                             ("beam", {"lstm_seq": L, "topk2d_lse": 20})):
            card16, n = counted(device, f"bf16 {method} B={len(batch)}", want,
                                lambda: p16.predict_batch(batch, method=method, beam_size=5))
            out["launches"] = add_counts(out["launches"], n)
            card32 = p32.predict_batch(batch, method=method, beam_size=5)
            cpu = cpu16.predict_batch(batch[:cpu_clips], method=method, beam_size=5)
            vs_cpu = agreement(card16[:cpu_clips], cpu)
            vs_f32 = agreement(card16, card32)
            out["agreement"][method] = {"card_vs_cpu_bf16": vs_cpu, "bf16_vs_f32": vs_f32}
            print(f"[bf16] {method} B={len(batch)} on {device}: clip agreement with the CPU "
                  f"port's bf16 run (first {cpu_clips}) {vs_cpu:.4f}, with the card's float32 "
                  f"run {vs_f32:.4f}; first divergence vs float32 at "
                  f"{first_divergence(card16, card32)[:16]}, vs CPU at "
                  f"{first_divergence(card16[:cpu_clips], cpu)}; launches "
                  f"{ {k: n[k] for k in want} }")
        if out["agreement"]["greedy"]["card_vs_cpu_bf16"] < MIN_BF16_GREEDY_AGREEMENT:
            raise AssertionError(f"bf16 greedy card vs CPU agreement "
                                 f"{out['agreement']['greedy']} < {MIN_BF16_GREEDY_AGREEMENT}")
        if device == "cuda":
            out["profile"]["bfloat16"] = profile_decode(p16, batch, card)
            out["profile"]["float32"] = profile_decode(p32, batch, card)
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
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    build_kernels()
    topk = check_topk("cuda", smi)
    topk_k = check_topk2d("cuda", smi)
    lstm = check_lstm("cuda", smi)
    check_lstm_edges("cuda", smi)
    cell = check_lstm_cell("cuda", smi)
    attn = check_attention("cuda", smi)
    vocab = check_vocab_topk("cuda", smi)
    config = Config()
    clips = np.random.default_rng(1).standard_normal(
        (128, config.model.video_sequence_length, config.model.cnn_feature_dim),
        dtype=np.float32)
    self_attn = check_beam_self_attention("cuda", smi)
    cross_attn = check_beam_cross_attention("cuda", smi)
    sl = run_slice("cuda", config, clips, cpu_clips=16, card=smi)
    fsl = run_slice("cuda", fused_config(), clips, cpu_clips=8, card=smi)
    tsl = run_slice("cuda", transformer_config(), clips, cpu_clips=8, card=smi)
    tfsl = run_slice("cuda", fused_transformer_config(), clips, cpu_clips=8, card=smi)
    train = check_lstm_train("cuda", smi, B=32)
    train128 = check_lstm_train("cuda", smi, B=128)
    # The B = 128 backward (bench.py's batch) and cuDNN's, beside B = 32's.
    train["bwd"]["b128"] = {k: train128["bwd"][k] for k in (
        "ms", "graph_ms", "sweep_device_ms", "dw_device_ms", "bound_ms", "library_ms")}
    tr = run_training(smi, config)
    check_step_parity(smi, config)
    check_overfit_and_profile(smi, config)
    bottleneck = check_fused_bottleneck("cuda", smi)
    mm = check_conv1x1("cuda", smi)
    i8, i8_res = check_int8_matmul("cuda", smi)
    ext = run_extraction(smi)
    ttr = run_transformer_training(smi)
    entry = run_entry_points(smi)
    wide = run_wide_encoder(smi, clips)
    options = run_decoder_options(smi, clips)
    sampling = run_sampling(smi, clips)
    bf16 = run_bf16_serving(smi, clips)
    launches = {k: sum(run["launches"][k] for run in (sl, fsl, tsl, tfsl, tr, ttr["train"], entry,
                                                      wide, options, sampling, bf16))
                + sum(n.get(k, 0) for n in ext["launches"].values())
                for k in sl["launches"]}
    kernels = []
    train_src = "video_captioning_tpu_torch/csrc/lstm_seq_train.cu"
    for name_, counter, src, replaces, res in (
        ("topk2d_lse", "topk2d_lse", "video_captioning_tpu_torch/csrc/topk_lse.cu",
         "video_captioning_tpu/ops/topk_pallas.py:55", topk),
        ("lstm_seq", "lstm_seq", "video_captioning_tpu_torch/csrc/lstm_seq.cu",
         "video_captioning_tpu/ops/lstm_seq_pallas.py:49", lstm),
        ("lstm_seq_train_fwd", "lstm_seq_train_fwd", train_src,
         "video_captioning_tpu/ops/lstm_seq_pallas.py:180", train["fwd"]),
        ("lstm_seq_train_bwd", "lstm_seq_train_bwd", train_src,
         "video_captioning_tpu/ops/lstm_seq_pallas.py:244", train["bwd"]),
        # No caller on any path, in either package: launched by the kernel
        # phase only, so its main-path count is 0.
        ("topk2d", "topk2d", "video_captioning_tpu_torch/csrc/topk_lse.cu",
         "video_captioning_tpu/ops/topk_pallas.py:37", topk_k),
        ("bahdanau_attend", "bahdanau_attend",
         "video_captioning_tpu_torch/csrc/bahdanau_attend.cu",
         "video_captioning_tpu/ops/attention_pallas.py:38", attn),
        ("lstm_cell", "lstm_cell_fused", "video_captioning_tpu_torch/csrc/lstm_cell.cu",
         "video_captioning_tpu/ops/lstm_pallas.py:32", cell),
        ("vocab_topk_lse", "vocab_topk_lse", "video_captioning_tpu_torch/csrc/vocab_topk.cu",
         "video_captioning_tpu/ops/vocab_topk_pallas.py:69", vocab),
        ("beam_self_attention", "beam_self_attention",
         "video_captioning_tpu_torch/csrc/transformer_attn.cu",
         "video_captioning_tpu/ops/transformer_attn_pallas.py:90", self_attn),
        ("beam_cross_attention", "beam_cross_attention",
         "video_captioning_tpu_torch/csrc/transformer_attn.cu",
         "video_captioning_tpu/ops/transformer_attn_pallas.py:245", cross_attn),
        ("fused_bottleneck", "fused_bottleneck",
         "video_captioning_tpu_torch/csrc/fused_bottleneck.cu",
         "video_captioning_tpu/ops/bottleneck_pallas.py:61", bottleneck),
        # No caller on any path, in either package: launched by the kernel
        # phase only, so its main-path count is 0.
        ("matmul_bias_act", "matmul_bias_act", "video_captioning_tpu_torch/csrc/conv1x1.cu",
         "video_captioning_tpu/ops/conv1x1_pallas.py:75", mm),
        ("int8_matmul_requant", "int8_matmul_requant",
         "video_captioning_tpu_torch/csrc/int8_matmul.cu",
         "video_captioning_tpu/ops/int8_matmul_pallas.py:48", i8),
        ("int8_matmul_residual_requant", "int8_matmul_residual_requant",
         "video_captioning_tpu_torch/csrc/int8_matmul.cu",
         "video_captioning_tpu/ops/int8_matmul_pallas.py:58", i8_res),
    ):
        kernels.append({"name": name_, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[counter], **res})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
