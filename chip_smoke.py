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
   fixed cost and the cost a step), the same at (80, 2, 128, 4096) for
   the wide form (600 < H <= 1024) beside cuDNN's LSTM of width 1024
   (each form's ptxas registers and spilled bytes printed beside its step
   time; for ``lstm_seq_train``'s backward also the sweep's and the dW_hh
   launch's profiler times, the dW_hh launch's parts (its plan,
   ``ops/lstm_seq_train.py:dw_plan``) and registers, the sweep's registers
   and spills and the wide sweep's plan), then ``lstm_seq`` (both xproj types)
   and both ``lstm_seq_train`` launches at 30 small odd shapes (T in
   (1, 5), B in (1, 3, 37), H in (40, 600, 608, 1000, 1024), a length-1
   row), every LSTM
   kernel launched twice on the same inputs and required bitwise equal,
   ``lstm_cell`` at N = 640 (In = 1024 and 512) and N = 128,
   ``bahdanau_attend`` at B = 128, S = 80, D = A = E = 512 with a ragged
   mask and an all-masked row (and at five edge shapes, with and without a
   mask; every launch repeated bitwise; graph-replay device times), ``vocab_topk_lse`` at (640, 512) x
   (512, 10000) and at odd shapes (N = 1, 37 with H = 200, 2560; Vp = 136)
   on integer operands (exact, ties crafted across tile and span
   boundaries) and at the main shape on random ones, each launched twice
   and required bitwise equal, with graph-replay device times (W warm in
   L2, and cold) beside the bf16 ``torch.addmm`` + ``torch.topk`` +
   ``torch.logsumexp`` composite's,
   ``beam_self_attention`` at the transformer's beam step (B = 128, K = 5,
   D = 512, 8 heads, T = 21, t = 19; float32 and bfloat16 caches; one
   kernel node a call, graph-replay device times warm and cold; at ten
   edge shapes too, its launcher's plan held to ``self_plan``) and
   ``beam_cross_attention`` (B = 128, K = 5, S = 80, D = 512, ragged mask
   with an all-masked row; within 1e-7 of its plain version in float32;
   its two launches a call counted in a captured CUDA graph, graph-replay
   device time beside the PyTorch composite of its whole function and SDPA's
   context alone), each also at odd shapes (the cross kernel at twelve,
   every launch repeated bitwise), with the
   profiler's device time beside the CUDA-event time; both also with a
   bfloat16 query (the bfloat16 beam state's forms: outputs within one
   bf16 ulp beyond BEAM_ATTN_ATOL of the plain versions, the context bit
   for bit the float32-query form's rounded, graph-replay device times
   beside the float32 query's, the library calls in bfloat16);
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
   their plain versions at (80, 2, 32, 2048), (80, 2, 128, 2048) and, for
   the wide forms, (80, 2, 32, 4096), each
   launched twice and required bitwise equal, with CUDA-event and
   graph-replay times, T = 1 against T = 80, and the backward's sweep and
   dW_hh launch timed apart by the profiler, the dW_hh product also as
   one bf16 ``bmm`` with float32 output;
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
7. the CNN backbones: ``fused_bottleneck`` at its edge shapes and every
   stage's identity block at B = 32 in float32 and bfloat16 (each plan's
   cluster, channels a CTA and active-cluster count printed), ``matmul_bias_act``
   at stage 1's conv3 with its three epilogues (graph-replay device time
   beside the F.linear + add + ReLU composite's, the bound and the share of
   it reached), ``conv1x1`` at stride 2 and CONV1X1_EDGE_SHAPES in float32
   and bfloat16 (every launch twice, bitwise equal), both int8 kernels at
   eight small odd shapes under every plan ``int8_plan`` weighs, stage 1's
   1x1 shapes and the last block's (exactly equal to their plain versions,
   two launches bitwise equal), then at the 17 shapes of a B = 32 forward,
   each plan forced in turn and bitwise equal to the launcher's choice,
   device time against ``torch._int_mm`` by CUDA-graph replay, summed over
   its 32 launches beside the bound, and at B = 16 each plan forced beside
   the launcher's choice; then the
   extraction slice: ``cli.preprocess.VideoFeatureExtractor`` over 2 clips
   of 80 seeded 224 x 224 frames (standing in for the OpenCV decoder) with
   VGG16 and ResNet50 ``folded``, ``fused``, ``fused_s2d``, ``int8`` without
   and with ``int8_conv1x1_pallas``, and ``fused`` and ``folded`` in
   bfloat16 (the two side by side in one run), numpy-seeded
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
10. a wide encoder (``encoder_hidden_dim=1024``, through the recurrence
   kernels' wide forms): 8 clips served with beam 5 (one wide ``lstm_seq``
   launch a layer) and one training step (one wide ``lstm_seq_train``
   forward and backward a layer), the encoder's log line naming the kernel
   and its limit (``lstm_seq_eligible``), tokens equal to the CPU run, the
   loss and gradients within STEP_LOSS_RTOL / STEP_GRAD_RTOL, and the
   encode of the 8 clips timed through the kernel and through the float32
   scan;
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
14. W8A8 decode (``run_int8_decode``) on a B = 128 batch of the sharpened,
   END-suppressed package: ``Config()`` at ``vocab`` (greedy, beam-5),
   ``fused_config()`` at ``vocab`` (beam-5, greedy), the transformer and
   its fused beam attention at ``full`` (beam-5): launches exactly as
   implied (no ``vocab_topk_lse`` with an int8 vocabulary) and the
   ``torch._int_mm`` calls (one a step at ``vocab``; 17 a step and 4 a
   decode at ``full``), the first 8 clips' tokens equal to the CPU port's
   int8 run, int8 against float32 agreement on the card, the decode
   weights' bytes, and encode + beam-5 profiled beside float32;
15. bfloat16 training (``run_bf16_training``): both ``lstm_seq_train``
   launches on bfloat16 xproj against their plain versions at
   (80, 2, 32, 2048) and the odd shapes, then ``cli.train --compute-dtype
   bfloat16 --profile-dir`` for 2 epochs at B = 32 on 96 clips through the
   native batch loader (every batch native, lstm_seq_train launched on
   bfloat16 xproj, the trace written, finite losses), one step at B = 8
   against the CPU and one step at B = 32 profiled beside float32;
16. bfloat16 under the fused decode-step flags (``run_bf16_fused``):
   ``fused_config()`` with ``compute_dtype="bfloat16"``, greedy and beam-5
   at B = 128, launches exactly as implied (40 ``lstm_cell`` a decode,
   ``bahdanau_attend`` once a greedy step, ``vocab_topk_lse`` once a beam
   step), clip agreement with the CPU port's bfloat16 run (greedy at least
   MIN_BF16_GREEDY_AGREEMENT), encode + beam-5 profiled beside float32;
17. the exported serving artifact (``run_export``): ``cli.export`` on the
   card of the LSTM default (buckets 8 and 128) and the fused transformer
   (bucket 128); ``ExportedPredictor`` serves 100 and 8 clips with tokens
   equal to the live predictor's, the programs' ``vct::`` custom ops
   counted as kernel launches (2 ``lstm_seq`` and 20 ``topk2d_lse`` a call;
   40 of each beam attention kernel), exported encode + beam-5 profiled
   beside the live one;
18. the transformer in bfloat16 (``run_bf16_transformer``):
   ``transformer_config()`` and ``fused_transformer_config()`` with
   ``compute_dtype="bfloat16"``, the fused one also with
   ``transformer_bf16_beam_state`` and with ``transformer_cross_kv_bf16``
   in float32 and bfloat16, greedy and beam-5 at B = 128: launches exactly
   as implied (40 of each beam-attention kernel and 20 ``topk2d_lse`` a
   fused beam search), each greedy step's logits within BF16_LOGIT_RTOL of
   the CPU port's (teacher-forced along its tokens), clip agreement with
   the CPU port's run and the card's float32 run recorded (the float32 arm
   gated at MIN_CLIP_AGREEMENT), encode + beam-5 of each arm profiled
   beside float32;
19. bfloat16 ``.vcx`` artifacts (``run_bf16_export``): ``Config()``
   greedy, whose program must be handed bfloat16 features (ROADMAP C.7)
   and give the live model's tokens on them, and the fused transformer
   with ``transformer_bf16_beam_state``, beam-5: both kernels launched with
   a bfloat16 query and held against their plain versions on the inputs
   they got, tokens beside the CPU port's on the same bfloat16 features;
20. data parallelism (``run_parallel``): a one-rank NCCL process group
   whose DP train step at B = 32 equals the step without one (loss and
   every gradient; both ``lstm_seq_train`` kernels launched), the DP step
   across 2 NCCL ranks where two cards are visible (a line says so
   otherwise), ``cli.serve --data-parallel`` answering ``/caption`` with
   the tokens of a predictor without a mesh, and the orbax backend
   (``torch.distributed.checkpoint``) through ``cli.train``: 2 epochs, a
   resume whose parameters and Adam moments equal the trained ones, one
   more epoch through ``--resume``;
21. a JSON line of the kernels, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import contextlib
import csv
import ctypes
import importlib
import io
import itertools
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
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
    card_plan,
    fused_bottleneck,
    fused_bottleneck_reference,
)
from video_captioning_tpu_torch.ops.conv1x1 import (
    conv1x1,
    matmul_bias_act,
    matmul_bias_act_reference,
)
from video_captioning_tpu_torch.ops.int8_matmul import (
    PLAN_KEYS as INT8_PLAN_KEYS,
    _launch as int8_launch,
    active_ctas as int8_active_ctas,
    card_plan as int8_card_plan,
    int8_candidates,
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
from video_captioning_tpu_torch.ops.lstm_seq import (
    NARROW_MAX_HIDDEN,
    kernel_max_hidden,
    lstm_seq,
    lstm_seq_reference,
)
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    bwd_wide_plan,
    dw_plan,
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
    MASK_FILL,
    beam_cross_attention,
    beam_cross_attention_reference,
    beam_self_attention,
    beam_self_attention_reference,
    gather_beam_prefix,
    kernel_self_plan,
    self_plan,
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
# The transformer in bfloat16, card against the CPU port: every linear
# rounds its float32 input to bfloat16 (about a dozen roundings a block and
# step, where the LSTM has a few), so those flips part 9–14% of the 128
# clips' greedy decodes at full width, and as many with float32 GEMMs of
# the bfloat16 values on the card (PERF.md): a token gate on 16 of
# them passes or fails by chance. The decode is held by value instead:
# each greedy step's logits, teacher-forced along the CPU's tokens, within
# the CPU tests' 2e-2 of the largest CPU value (tests/test_torch_bf16.py:
# REL, the port against JAX), END's suppressed column left out.
BF16_LOGIT_RTOL = 2e-2
# A data-parallel step against the step without a process group: the
# tests' DP tolerances (tests/test_torch_parallel.py), here over every
# gradient's max error relative to the largest gradient value.
DP_LOSS_RTOL = 1e-6
DP_GRAD_RTOL = 1e-5
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
# beam_cross_attention at the main shape in float32: the int8 `full`
# decode quantizes its context, so a kernel more than about 6e-8 from the
# plain version flips int8 roundings (run_int8_decode's gate).
CROSS_MAIN_ATOL = 1e-7
# The bfloat16-query forms of both: the float32 results above, each rounded
# once to bfloat16 (the head-mean weights by the JAX kernel's head blocks);
# where the float32 values differ they may round to neighbouring bfloat16
# values, so one bfloat16 ulp beyond BEAM_ATTN_ATOL (a context near 0 is a
# sum of terms of both signs, whose float32 difference can be many bfloat16
# ulps of the small result). The context must also be, bit for bit, the
# float32-query form's on the widened query, rounded once.
BF16_ULP_TOL = 1.0
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


def kernel_resources(source: str, match: str) -> dict:
    """Registers and spill bytes that ptxas reported (``-Xptxas -v``, in
    the build log of csrc/<source>.cu) for each kernel whose mangled name
    contains ``match``."""
    out, name = {}, None
    for line in build.build_logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or match not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


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


def check_lstm(device: str, card: str, H: int = 512) -> dict:
    """``lstm_seq`` at (80, 2, 128, 4H), float32 and bfloat16 xproj, against
    its plain version, launched twice and required bitwise equal; times by
    CUDA events and graph replay beside the plain version, the bound and
    cuDNN's bidirectional LSTM layer of width H. H = 512 is the main path's
    narrow form, H = 1024 the wide form."""
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        xproj, w, mask = lstm_inputs(device, dtype, H=H)
        got = lstm_seq(xproj, w, mask)
        want = lstm_seq_reference(xproj, w, mask)
        again = lstm_seq(xproj, w, mask)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0]), (got[1][0], want[1][0]), (got[1][1], want[1][1])]
        err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        pad = mask.T[:, None, :, None].expand(got[0].shape) == 0
        if err > LSTM_ATOL[dtype] or bool((got[0][pad] != 0).any()):
            raise AssertionError(f"lstm_seq H={H} {dtype}: max abs err {err:.3g} > "
                                 f"{LSTM_ATOL[dtype]} or a padded step emitted nonzero")
        if not same_bits((got[0], *got[1]), (again[0], *again[1])):
            raise AssertionError(f"lstm_seq H={H} {dtype}: two launches on the same inputs "
                                 f"differ")
        ms = time_ms(lambda: lstm_seq(xproj, w, mask), calls=10)
        dev_ms = graph_ms(lambda: lstm_seq(xproj, w, mask))
        plain_ms = time_ms(lambda: lstm_seq_reference(xproj, w, mask), calls=3)
        print(f"[kernels] lstm_seq {tuple(xproj.shape)} {dtype}: max abs err {err:.3g} "
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
            print(f"[kernels] lstm_seq H={H} {dtype}: bound {lim['bound_ms']:.4f} ms "
                  f"({lim['bound_by']}), cuDNN LSTM forward in {dtype} {lib_ms:.4f} ms ({card})")
            result["main"]["bf16"] = dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                                          plain_ms=plain_ms, library_ms=lib_ms, **lim)
        if "main" not in result:
            def seq_call(n):
                x_n, m_n = xproj[:n], mask[:, :n].contiguous()
                return lambda: lstm_seq(x_n, w, m_n)

            steps = graph_step_ms(seq_call)
            ptxas = fwd_resources("lstm_seq")
            result["main"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  graph_ms=dev_ms, **steps, **lim, **ptxas)
            print(f"[kernels] lstm_seq H={H}: bound {result['main']['bound_ms']:.4f} ms "
                  f"({result['main']['bound_by']}), cuDNN LSTM forward {lib_ms:.4f} ms; "
                  f"graph T=1 {steps['T1_graph_ms']:.4f} ms, T=80 {steps['T80_graph_ms']:.4f} "
                  f"ms: {steps['step_us']:.3f} us a step; ptxas: {ptxas['registers']} registers, "
                  f"{ptxas['spill_bytes']} bytes spilled ({card})")
    return result["main"]


def fwd_resources(source: str) -> dict:
    """The most registers and spill-store bytes ptxas reported for the
    forward kernel's instantiations of csrc/<source>.cu (one tile for
    every H)."""
    res = kernel_resources(source, "lstm_seq_fwd_kernel")
    return {"registers": max((r.get("registers", 0) for r in res.values()), default=None),
            "spill_bytes": max((r.get("spill_stores", 0) for r in res.values()), default=None)}


def bwd_resources(H: int) -> dict:
    """The most registers and spill-store bytes ptxas reported for the
    backward sweep's instantiations at this H: the narrow form's
    (``lstm_seq_bwd_kernel``) or the wide form's (``lstm_seq_bwd_wide_kernel``)."""
    res = kernel_resources("lstm_seq_train", "lstm_seq_bwd_wide_kernel" if H > NARROW_MAX_HIDDEN
                           else "lstm_seq_bwd_kernel")
    return {"bwd_registers": max((r.get("registers", 0) for r in res.values()), default=None),
            "bwd_spill_bytes": max((r.get("spill_stores", 0) for r in res.values()),
                                   default=None)}


# Small odd shapes the kernels' tiling must take: B not a multiple of the
# row chunks, H = 40 (not a multiple of 16 or 32) and H = 600 (the narrow
# forms' largest), H = 608 (the wide forms' smallest), 1000 (not a multiple
# of 16: half a unit group masked) and 1024 (the largest), T = 1 (no
# recurrent product) and 5; a ragged mask whose last row has length 1 (row
# 0 full).
LSTM_EDGE_HIDDEN = (40, 600, 608, 1000, 1024)
LSTM_EDGE_SHAPES = tuple((T, B, H) for T in (1, 5) for B in (1, 3, 37) for H in LSTM_EDGE_HIDDEN)


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
          f"(T in (1, 5), B in (1, 3, 37), H in {LSTM_EDGE_HIDDEN}, a length-1 row): worst errors "
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


def dw_library_call(h_keep: torch.Tensor, dxproj: torch.Tensor):
    """The dW_hh launch's function as one PyTorch call, for timing beside
    them: the batched product of bf16 h_keep[t - 1]^T and bf16 dxproj[t]
    over t >= 1 and the rows, float32 out (``aten::bmm.dtype``), on
    operands cast and laid out beforehand."""
    T, ND, B, H = h_keep.shape
    h = h_keep[:-1].permute(1, 3, 0, 2).reshape(ND, H, (T - 1) * B).to(torch.bfloat16)
    dx = dxproj[1:].permute(1, 0, 2, 3).reshape(ND, (T - 1) * B, 4 * H).to(torch.bfloat16)
    h, dx = h.contiguous(), dx.contiguous()
    return lambda: torch.ops.aten.bmm.dtype(h, dx, torch.float32)


def check_lstm_train(device: str, card: str, B: int, H: int = 512) -> dict:
    """Forward (outputs, final state, the three residuals) and backward
    (dxproj, dW_hh, with random cotangents) against the plain versions on
    the card, float32 xproj, ragged mask; each launched twice and required
    bitwise equal. Times: CUDA events, graph replay, the sweep and dW_hh
    launches apart (profiler), T = 1 against T = 80; cuDNN's bidirectional
    LSTM layer of width H, and the dW_hh product as one bf16 ``bmm``.
    H = 512 is the main path's narrow form, H = 1024 the wide form."""
    T, ND = 80, 2
    xproj, w, mask = lstm_inputs(device, torch.float32, T=T, ND=ND, B=B, H=H)
    got = lstm_seq_train_fwd(xproj, w, mask)
    again = lstm_seq_train_fwd(xproj, w, mask)
    want = lstm_seq_train_fwd_reference(xproj, w, mask)
    torch.cuda.synchronize()
    names = ("outs", "h_last", "c_last", "gact", "h_keep", "c_keep")
    fwd_err = {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, got, want)}
    if max(fwd_err.values()) > LSTM_TRAIN_FWD_ATOL:
        raise AssertionError(f"lstm_seq_train_fwd B={B} H={H}: max abs err {fwd_err} > "
                             f"{LSTM_TRAIN_FWD_ATOL}")
    if not same_bits(got, again):
        raise AssertionError(f"lstm_seq_train_fwd B={B} H={H}: two launches on the same "
                             f"inputs differ")
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
        raise AssertionError(f"lstm_seq_train_bwd B={B} H={H}: max err relative to the largest "
                             f"value {bwd_err} > {LSTM_TRAIN_BWD_RTOL}")
    if not same_bits(bgot, bagain):
        raise AssertionError(f"lstm_seq_train_bwd B={B} H={H}: two launches on the same "
                             f"inputs differ")
    out = {"fwd": dict(max_abs_err=max(fwd_err.values())),
           "bwd": dict(max_abs_err=max((a - b).abs().max().item()
                                       for a, b in zip(bgot, bwant)))}
    out["fwd"]["ms"] = time_ms(fwd, calls=5)
    out["fwd"]["graph_ms"] = graph_ms(fwd)
    out["fwd"].update(graph_step_ms(fwd_call))
    out["fwd"].update(fwd_resources("lstm_seq_train"))
    out["fwd"]["plain_ms"] = time_ms(lambda: lstm_seq_train_fwd_reference(xproj, w, mask),
                                     calls=1, runs=3)
    out["bwd"]["ms"] = time_ms(bwd, calls=5)
    out["bwd"]["graph_ms"] = graph_ms(bwd)
    out["bwd"].update(graph_step_ms(bwd_call))
    out["bwd"]["sweep_device_ms"] = device_ms(bwd, calls=5, keys=("lstm_seq_bwd",))
    out["bwd"]["dw_device_ms"] = device_ms(bwd, calls=5, keys=("lstm_seq_dw",))
    out["bwd"].update(bwd_resources(H))
    # Printed, not measured: the dW_hh launch's parts (its plan's) and
    # registers, and the wide sweep's plan as ops/lstm_seq_train.py:
    # bwd_wide_plan mirrors it.
    dw_parts = dw_plan(T, B, H, ND, torch.cuda.get_device_properties(0).multi_processor_count)[
        "parts"]
    dw_regs = max((r.get("registers", 0) for r in kernel_resources(
        "lstm_seq_train", "lstm_seq_dw_kernel").values()), default=None)
    plan = "narrow"
    if H > NARROW_MAX_HIDDEN:
        plan = {k: v for k, v in bwd_wide_plan(H, B, ND).items()
                if k in ("ctas", "nb", "stages", "ring", "smem")}
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
    dw_lib = dw_library_call(res[1], bgot[0])
    dw_lib_rel = ((dw_lib() - bgot[1]).abs().max() / bgot[1].abs().max()).item()
    out["bwd"]["dw_library_ms"] = graph_ms(dw_lib)
    lstm, x = cudnn_lstm(B, device, H=H)
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
          f"{f['T1_graph_ms']:.4f} ms, {f['step_us']:.3f} us a step; ptxas "
          f"{f['registers']} registers, {f['spill_bytes']} bytes spilled), plain "
          f"{f['plain_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms, cuDNN LSTM fwd "
          f"{f['library_ms']:.4f} ms; bwd kernels {b_['ms']:.4f} ms (graph {b_['graph_ms']:.4f} "
          f"ms; T=1 {b_['T1_graph_ms']:.4f} ms, {b_['step_us']:.3f} us a step; profiler: sweep "
          f"{b_['sweep_device_ms']:.4f} ms, dW_hh {b_['dw_device_ms']:.4f} ms against its bound "
          f"{b_['dw_bound_ms']:.4f} ms; one bf16 bmm of the same product, float32 out, "
          f"{b_['dw_library_ms']:.4f} ms by graph replay, {dw_lib_rel:.3g} from the kernels' "
          f"dW_hh relative to its largest value; dW_hh rows in {dw_parts} parts of a cluster, "
          f"ptxas {dw_regs} registers), "
          f"plain {b_['plain_ms']:.4f} ms, bound {b_['bound_ms']:.4f} ms, cuDNN LSTM bwd "
          f"{b_['library_ms']:.4f} ms; sweep ptxas {b_['bwd_registers']} registers, "
          f"{b_['bwd_spill_bytes']} bytes spilled; sweep plan (mirror) {plan} "
          f"({card})")
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
    all masked, row 2 with one valid frame (the later CTAs' slices all
    masked)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = 1.0 / D ** 0.5

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * r

    h = torch.tanh(torch.randn((B, D), generator=g))
    enc_outs = torch.randn((B, S, E), generator=g) * 0.5
    enc_proj = torch.randn((B, S, A), generator=g) * 0.5
    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0] = S
    if B > 2:
        lengths[2] = 1
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(torch.float32)
    if B > 1:
        mask[1] = 0.0
    args = (h, u(A, D), u(A), enc_proj, enc_outs, u(A), u(1), mask)
    return tuple(a.to(device) for a in args)


# bahdanau_attend's edge shapes (B, S, D, A, E): one frame; S not a multiple
# of the cluster's split with A != E; a slice longer than a chunk (the
# ring); A % 4 != 0 (loads without bulk copies); B = 37 (a partial dec_proj
# row block).
ATTN_EDGE_SHAPES = ((3, 1, 64, 32, 48), (37, 13, 64, 32, 48), (5, 2000, 64, 512, 512),
                    (3, 41, 30, 30, 50), (37, 80, 512, 512, 512))


def _attend_close(got, want) -> tuple:
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    rel = max(((a - b).abs() / b.abs().clamp_min(1.0)).max().item() for a, b in zip(got, want))
    return err, rel


def check_attention(device: str, card: str) -> dict:
    """The attention step against its plain version at B = 128 (the greedy
    batch), D = A = E = 512, S = 80, and at ATTN_EDGE_SHAPES, each with a
    ragged mask (an all-masked row, a row whose later slices are all
    masked) and with none: context and weights within ATTN_TOL, the
    all-masked row uniform within 1e-7, two launches bitwise equal."""
    for B, S, D, A, E in ATTN_EDGE_SHAPES:
        args = attention_inputs(device, B, S, D, A, E, seed=9)
        for mask in (args[-1], None):
            a = (*args[:-1], mask)
            got = bahdanau_attend(*a)
            again = bahdanau_attend(*a)
            torch.cuda.synchronize()
            err, rel = _attend_close(got, bahdanau_attend_reference(*a))
            uniform = 0.0 if mask is None else (got[1][1] - 1.0 / S).abs().max().item()
            if not (rel <= ATTN_TOL and uniform <= 1e-7 and same_bits(got, again)):
                raise AssertionError(
                    f"bahdanau_attend B={B} S={S} D={D} A={A} E={E} mask "
                    f"{'ragged' if mask is not None else 'none'}: max err {err:.3g} (rel "
                    f"{rel:.3g}) > {ATTN_TOL}, the all-masked row {uniform:.3g} from uniform, "
                    f"or two launches differ")
    print(f"[kernels] bahdanau_attend at {len(ATTN_EDGE_SHAPES)} edge shapes (B, S, D, A, E) "
          f"{ATTN_EDGE_SHAPES}, ragged mask and none: within {ATTN_TOL}, all-masked rows "
          f"uniform within 1e-7, two launches bitwise equal")
    args = attention_inputs(device)
    h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask = args
    got = bahdanau_attend(*args)
    again = bahdanau_attend(*args)
    want = bahdanau_attend_reference(*args)
    torch.cuda.synchronize()
    err, rel = _attend_close(got, want)
    S = mask.shape[1]
    uniform = (got[1][1] - 1.0 / S).abs().max().item()
    if rel > ATTN_TOL or uniform > 1e-7 or not torch.isfinite(got[0]).all():
        raise AssertionError(f"bahdanau_attend: max err {err:.3g} (rel {rel:.3g}) > {ATTN_TOL}, "
                             f"or the all-masked row is {uniform:.3g} from uniform")
    if not same_bits(got, again):
        raise AssertionError("bahdanau_attend: two launches on the same inputs differ")
    B, D = h.shape
    A, E = enc_proj.shape[2], enc_outs.shape[2]
    cfg = Config()
    attn = BahdanauAttention(cfg).to(device)
    cold = [args, attention_inputs(device, seed=18)]  # 84 MB: each call misses L2
    with torch.no_grad():
        attn.decoder_projection.weight.copy_(w_d)
        attn.decoder_projection.bias.copy_(b_d)
        attn.attention_linear.weight.copy_(v[None])
        attn.attention_linear.bias.copy_(b_v)
        cache = {"enc_proj": enc_proj}
        res = dict(max_abs_err=err, ms=time_ms(lambda: bahdanau_attend(*args), 50),
                   graph_ms=graph_ms(lambda: bahdanau_attend(*args)),
                   cold_graph_ms=graph_ms(_rotating(bahdanau_attend, cold), calls=10),
                   plain_ms=time_ms(lambda: bahdanau_attend_reference(*args), 50),
                   library_ms=time_ms(lambda: attend(cfg, attn, cache, enc_outs, h, mask), 50),
                   library_graph_ms=graph_ms(lambda: attend(cfg, attn, cache, enc_outs, h, mask)),
                   **bound(nbytes=4 * (B * D + A * D + 2 * A + 1 + B * S * (A + E)
                                       + 2 * B * S + B * E),
                           flops=2 * B * A * D + 3 * B * S * A + 2 * B * S * E,
                           peak_flops=F32_FLOPS))
    print(f"[kernels] bahdanau_attend B={B} S={S} D=A=E={D}: max abs err {err:.3g} (tol "
          f"{ATTN_TOL}), all-masked row uniform within {uniform:.3g}, two launches bitwise "
          f"equal; kernel {res['ms']:.4f} ms (device {res['graph_ms']:.4f} ms by graph replay, "
          f"{res['cold_graph_ms']:.4f} ms with two input sets in turn), plain "
          f"{res['plain_ms']:.4f} ms, eager attend (a 7-call composite) {res['library_ms']:.4f} "
          f"ms (device {res['library_graph_ms']:.4f} ms), bound {res['bound_ms']:.4f} ms "
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


def kernel_profile(fn, calls: int) -> dict:
    """{CUDA kernel name: (launches, device ms)} over ``calls`` calls of fn
    after a warm-up, from torch.profiler: the card's own time, where a
    CUDA-event time of a call shorter than its host-side issue is the
    host's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def device_ms(fn, calls: int, keys: tuple) -> float:
    """Device time per call of the kernels whose names contain one of
    ``keys`` (kernel_profile)."""
    return sum(ms for name, (_, ms) in kernel_profile(fn, calls).items()
               if any(k in name for k in keys)) / calls


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


# cudaGraphNodeType (the CUDA runtime's driver_types.h): a kernel launch,
# and a child graph, whose own nodes are counted too.
GRAPH_NODE_KERNEL = 0
GRAPH_NODE_CHILD = 4


def cuda_runtime() -> ctypes.CDLL:
    """The CUDA runtime library that torch has loaded (``libcudart.so.<major>``
    of ``torch.version.cuda``), by ctypes, with the three graph queries that
    ``count_kernel_nodes`` calls. Raises, naming what is missing."""
    name = f"libcudart.so.{str(torch.version.cuda).split('.')[0]}"
    try:
        rt = ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
    except OSError as e:
        raise RuntimeError(f"torch has not loaded {name}, so the graph's kernel nodes cannot "
                           f"be counted ({e})") from e
    missing = [s for s in ("cudaGraphGetNodes", "cudaGraphNodeGetType",
                           "cudaGraphChildGraphNodeGetGraph") if not hasattr(rt, s)]
    if missing:
        raise RuntimeError(f"{name} lacks {missing}")
    return rt


def count_kernel_nodes(graph_handle: int, runtime) -> int:
    """The kernel nodes of the cudaGraph_t ``graph_handle`` and of its child
    graphs, through ``runtime``'s cudaGraphGetNodes, cudaGraphNodeGetType
    and cudaGraphChildGraphNodeGetGraph. Raises on any CUDA error."""
    def call(fn, *args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} returned CUDA error {rc}")

    n = ctypes.c_size_t(0)
    graph = ctypes.c_void_p(graph_handle)
    call(runtime.cudaGraphGetNodes, graph, None, ctypes.pointer(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(runtime.cudaGraphGetNodes, graph, nodes, ctypes.pointer(n))
    kernels = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        call(runtime.cudaGraphNodeGetType, ctypes.c_void_p(node), ctypes.pointer(kind))
        if kind.value == GRAPH_NODE_KERNEL:
            kernels += 1
        elif kind.value == GRAPH_NODE_CHILD:
            child = ctypes.c_void_p(0)
            call(runtime.cudaGraphChildGraphNodeGetGraph, ctypes.c_void_p(node),
                 ctypes.pointer(child))
            kernels += count_kernel_nodes(child.value, runtime)
    return kernels


def graph_launches(fn, calls: int) -> float:
    """Kernel launches a call of ``fn``, exactly: ``calls`` calls captured in
    one CUDA graph (after a warm-up on a side stream, as ``graph_ms``), its
    kernel nodes counted (``count_kernel_nodes``) and divided by ``calls``.
    Nothing is dropped, as a profiler's records can be. Raises where this
    torch cannot hand out the captured graph or the runtime lacks a query."""
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        raise RuntimeError(f"torch {torch.__version__}'s CUDAGraph takes no keep_graph, so "
                           f"its captured graph cannot be read ({e})") from e
    if not hasattr(graph, "raw_cuda_graph"):
        raise RuntimeError(f"torch {torch.__version__}'s CUDAGraph has no raw_cuda_graph")
    runtime = cuda_runtime()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return count_kernel_nodes(graph.raw_cuda_graph(), runtime) / calls


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


# beam_self_attention's edge shapes (B, K, D, heads, T, t): t = 0 and
# t = T - 1; K = 1, 2, 16; dh = 16, 32, 48 (not a multiple of 32), 64, 128
# and 25 (no 16-byte copies); two and three 32-position windows of the
# ancestry; odd B and B = 1.
SELF_EDGE_SHAPES = ((3, 2, 64, 4, 9, 0), (3, 2, 64, 4, 9, 4), (3, 2, 64, 4, 9, 8),
                    (5, 1, 256, 8, 21, 19), (3, 16, 512, 8, 21, 20), (3, 16, 1024, 8, 21, 13),
                    (7, 5, 384, 8, 21, 19), (3, 5, 100, 4, 21, 10), (3, 4, 256, 2, 70, 69),
                    (1, 5, 512, 8, 40, 33))
SELF_MAIN = (128, 5, 512, 8, 21, 19)


def check_self_plan(K: int, dh: int, t: int, cache_bytes: int) -> None:
    """The card launcher's plan (``kernel_self_plan``) is ``self_plan``'s."""
    got, want = kernel_self_plan(K, dh, t, cache_bytes), self_plan(K, dh, t, cache_bytes)
    if got != want:
        raise AssertionError(f"beam_self_attention K={K} dh={dh} t={t} {cache_bytes}-byte "
                             f"caches: the launcher's plan {got}, self_plan's {want}")


def check_beam_self_attention(device: str, card: str) -> dict:
    """The ancestry-select self-attention kernel against its plain version
    at the fused beam step's shape (SELF_MAIN: B = 128, K = 5, D = 512, 8
    heads, T = 21, t = 19; float32 and bfloat16 caches) and at
    SELF_EDGE_SHAPES, every launch repeated bitwise and its plan the
    Python mirror's; at the main shape one kernel node a call (captured
    graph), device time by graph replay with one input set (warm) and two
    layers' in turn (cold), beside the events' time, the profiler's, the
    plain version's, ``torch.gather`` + SDPA's and the bound."""
    for B, K, D, H, T, t in SELF_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, anc = beam_self_inputs(device, B, K, D, T, t, dtype, seed=10 + t)
            got = beam_self_attention(q, k, v, anc, t, H, K)
            again = beam_self_attention(q, k, v, anc, t, H, K)
            want = beam_self_attention_reference(q, k, v, anc, t, H, K)
            sync(device)
            err = (got - want).abs().max().item()
            if not (err <= BEAM_ATTN_ATOL and same_bits(got, again)):
                raise AssertionError(f"beam_self_attention B={B} K={K} D={D} h={H} T={T} t={t} "
                                     f"{dtype}: max abs err {err:.3g}, repeat bitwise "
                                     f"{same_bits(got, again)}")
            if device == "cuda":
                check_self_plan(K, D // H, t, k.element_size())
    print(f"[kernels] beam_self_attention at {len(SELF_EDGE_SHAPES)} edge shapes (K 1-16, dh "
          f"16-128 and 25, t = 0 to 69, up to three ancestry windows), float32 and bfloat16 "
          f"caches: within {BEAM_ATTN_ATOL}, two launches bitwise equal, the launcher's plan "
          f"self_plan's")
    B, K, D, H, T, t = SELF_MAIN
    if device == "cuda":
        regs = kernel_resources("transformer_attn", "beam_self_attn")
        print(f"[kernels] beam_self_attn_kernel ptxas: "
              f"{ {n[-40:]: r for n, r in sorted(regs.items())} }")
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        layers = [beam_self_inputs(device, B, K, D, T, t, dtype, seed=20 + i) for i in range(2)]
        q, k, v, anc = layers[0]
        got = beam_self_attention(q, k, v, anc, t, H, K)
        again = beam_self_attention(q, k, v, anc, t, H, K)
        want = beam_self_attention_reference(q, k, v, anc, t, H, K)
        sync(device)
        err = (got - want).abs().max().item()
        launches = graph_launches(lambda: beam_self_attention(q, k, v, anc, t, H, K), 10)
        if not (err <= BEAM_ATTN_ATOL and same_bits(got, again) and launches == 1):
            raise AssertionError(f"beam_self_attention {dtype}: max abs err {err:.3g} (tol "
                                 f"{BEAM_ATTN_ATOL}), repeat bitwise {same_bits(got, again)}, "
                                 f"{launches} launches a call")
        if device == "cuda":
            check_self_plan(K, D // H, t, k.element_size())
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
                   graph_ms=graph_ms(lambda: beam_self_attention(q, k, v, anc, t, H, K)),
                   cold_graph_ms=graph_ms(_rotating(lambda *a: beam_self_attention(*a, t, H, K),
                                                    layers), calls=10),
                   profiler_ms=dev, launches_a_call=launches,
                   **bound(nbytes=2 * distinct * D * esize + 4 * B * K * (t + 1)
                           + 2 * 4 * B * K * D,
                           flops=4 * B * K * (t + 1) * D, peak_flops=F32_FLOPS))
        print(f"[kernels] beam_self_attention B={B} K={K} D={D} h={H} T={T} t={t} {dtype} "
              f"caches: max abs err {err:.3g} (tol {BEAM_ATTN_ATOL}), two launches bitwise "
              f"equal, {launches:g} launch a call, plan {self_plan(K, D // H, t, esize)}; "
              f"kernel device "
              f"{res['graph_ms']:.4f} ms by graph replay ({res['cold_graph_ms']:.4f} ms with two "
              f"layers' inputs in turn; {res['bound_ms'] / res['graph_ms']:.2f} of the bound), "
              f"events {ms:.4f} ms, profiler {dev:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.gather + SDPA {lib_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}, {distinct} distinct rows of {(t + 1) * B * K}) ({card})")
        if dtype == torch.float32:
            result = res
        else:
            result["bf16"] = res
    result["bf16_query"] = check_beam_self_attention_bf16q(device, card)
    return result


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, atol: float = 0.0) -> float:
    """The largest |got - want| beyond ``atol``, in units of the bfloat16
    spacing at want (2^(e - 7) for |want| in [2^e, 2^(e + 1)))."""
    w = want.float()
    spacing = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return ((got.float() - w).abs().sub(atol).clamp_min(0.0) / spacing).max().item()


def check_beam_self_attention_bf16q(device: str, card: str) -> dict:
    """The bfloat16-query form (the bfloat16 beam state's): the context in
    bfloat16 within BF16_ULP_TOL of the plain version, at SELF_EDGE_SHAPES
    (float32 and bfloat16 caches) and the main shape (bfloat16 caches); two
    launches bitwise equal; one launch a call (captured graph); device time
    by graph replay beside
    the float32-query form's on the same caches, the plain version's,
    ``torch.gather`` + SDPA in bfloat16, and the bound."""
    for B, K, D, H, T, t in SELF_EDGE_SHAPES:
        for cdt in (torch.float32, torch.bfloat16):
            q, k, v, anc = beam_self_inputs(device, B, K, D, T, t, cdt, seed=10 + t)
            q = q.to(torch.bfloat16)
            got = beam_self_attention(q, k, v, anc, t, H, K)
            again = beam_self_attention(q, k, v, anc, t, H, K)
            ulps = bf16_ulps(got, beam_self_attention_reference(q, k, v, anc, t, H, K),
                             BEAM_ATTN_ATOL)
            rounded = beam_self_attention(q.float(), k, v, anc, t, H, K).to(torch.bfloat16)
            if (got.dtype != torch.bfloat16 or not ulps <= BF16_ULP_TOL
                    or not same_bits(got, rounded) or not same_bits(got, again)):
                raise AssertionError(f"beam_self_attention bf16 q B={B} K={K} D={D} h={H} T={T} "
                                     f"t={t} {cdt} caches: {got.dtype}, {ulps:g} bf16 ulps, the "
                                     f"float32 form's rounding {same_bits(got, rounded)}, repeat "
                                     f"bitwise {same_bits(got, again)}")
    print(f"[kernels] beam_self_attention bf16 query at {len(SELF_EDGE_SHAPES)} edge shapes, "
          f"float32 and bfloat16 caches: within {BF16_ULP_TOL:g} bf16 ulp beyond "
          f"{BEAM_ATTN_ATOL}, the float32 form's bits rounded, two launches bitwise equal")
    B, K, D, H, T, t = SELF_MAIN
    q, k, v, anc = beam_self_inputs(device, B, K, D, T, t, torch.bfloat16, seed=20)
    q16 = q.to(torch.bfloat16)
    got = beam_self_attention(q16, k, v, anc, t, H, K)
    again = beam_self_attention(q16, k, v, anc, t, H, K)
    want = beam_self_attention_reference(q16, k, v, anc, t, H, K)
    sync(device)
    ulps = bf16_ulps(got, want, BEAM_ATTN_ATOL)
    rounded = same_bits(got, beam_self_attention(q16.float(), k, v, anc, t, H, K)
                        .to(torch.bfloat16))
    launches = graph_launches(lambda: beam_self_attention(q16, k, v, anc, t, H, K), 10)
    if not (ulps <= BF16_ULP_TOL and rounded and same_bits(got, again) and launches == 1):
        raise AssertionError(f"beam_self_attention bf16 q: {ulps:g} bf16 ulps, the float32 "
                             f"form's rounding {rounded}, repeat bitwise "
                             f"{same_bits(got, again)}, {launches} launches a call")

    def library(q, k, v, anc):
        N, dh = B * K, D // H
        kh, vh = (gather_beam_prefix(c, anc, t).reshape(t + 1, N, H, dh).permute(1, 2, 0, 3)
                  for c in (k, v))
        return torch.nn.functional.scaled_dot_product_attention(q.reshape(N, H, 1, dh), kh, vh)

    rows = (torch.arange(B, device=device)[:, None, None] * K + anc[:, :, :t + 1].long())
    distinct = sum(torch.unique(rows[:, :, tau]).numel() for tau in range(t + 1))
    res = dict(max_abs_err=(got.float() - want.float()).abs().max().item(), max_bf16_ulps=ulps,
               max_bf16_ulps_raw=bf16_ulps(got, want),
               ms=graph_ms(lambda: beam_self_attention(q16, k, v, anc, t, H, K)),
               f32_query_ms=graph_ms(lambda: beam_self_attention(q, k, v, anc, t, H, K)),
               plain_ms=time_ms(lambda: beam_self_attention_reference(q16, k, v, anc, t, H, K),
                                calls=20),
               library_ms=graph_ms(lambda: library(q16, k, v, anc)),
               **bound(nbytes=2 * 2 * distinct * D + 4 * B * K * (t + 1) + 2 * 2 * B * K * D,
                       flops=4 * B * K * (t + 1) * D, peak_flops=F32_FLOPS))
    print(f"[kernels] beam_self_attention B={B} K={K} D={D} h={H} T={T} t={t} bf16 query, bf16 "
          f"caches: max abs err {res['max_abs_err']:.3g}, {ulps:g} bf16 ulps from the plain "
          f"version beyond {BEAM_ATTN_ATOL} ({res['max_bf16_ulps_raw']:g} without it; tol "
          f"{BF16_ULP_TOL:g}), the float32 form's bits rounded, two launches bitwise equal, "
          f"{launches:g} launch a call; kernel device "
          f"{res['ms']:.4f} ms by graph replay (float32 query on the same caches "
          f"{res['f32_query_ms']:.4f} ms), plain {res['plain_ms']:.4f} ms, torch.gather + SDPA "
          f"in bf16 device {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}) ({card})")
    return res


def beam_cross_inputs(device: str, B: int, K: int, S: int, D: int, seed: int,
                      dtype: torch.dtype = torch.float32):
    """q, un-expanded keys and values, a ragged mask with row 1 fully masked
    and row 2 with one valid frame."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B * K, D), generator=g)
    ck = torch.randn((B, S, D), generator=g).to(dtype)
    cv = torch.randn((B, S, D), generator=g).to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0] = S
    if B > 2:
        lengths[2] = 1
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(torch.float32)
    mask[1] = 0.0
    return tuple(x.to(device) for x in (q, ck, cv, mask))


# beam_cross_attention's edge shapes (B, K, S, D, heads, K/V dtype): S = 1;
# S = 9 and 41 (41: a 32-frame chunk and a ragged one); 300 frames of
# D = 1024 at K = 16 and 2000 frames at 16 heads; D = 2048 at K = 16; 12
# heads; dh = 15 (no vector loads) and bfloat16 dh = 4.
CROSS_EDGE_SHAPES = tuple(
    [(3, 2, S, 64, 4, dt) for S in (1, 9, 41) for dt in (torch.float32, torch.bfloat16)]
    + [(2, 16, 300, 1024, 8, torch.float32), (2, 16, 2000, 512, 16, torch.bfloat16),
       (2, 16, 40, 2048, 16, torch.float32), (3, 5, 37, 96, 12, torch.float32),
       (3, 2, 17, 60, 4, torch.float32), (3, 2, 17, 16, 4, torch.bfloat16)])


# The kernels of one beam_cross_attention call: the per-head launch and the
# head mean (csrc/transformer_attn.cu).
CROSS_KERNELS = ("beam_cross_attn_kernel", "head_mean_kernel")


def beam_cross_composite(q, ck, cv, mask, H: int, K: int):
    """beam_cross_attention's whole function in PyTorch calls: batched
    matmul, masked softmax, matmul and the mean over heads."""
    B, S, D = ck.shape
    dh = D // H
    qh = q.view(B, K, H, dh).transpose(1, 2)
    s = torch.matmul(qh, ck.view(B, S, H, dh).permute(0, 2, 3, 1)) * (1.0 / math.sqrt(dh))
    w = torch.softmax(s.masked_fill(mask[:, None, None, :] <= 0, MASK_FILL), dim=-1)
    ctx = torch.matmul(w, cv.view(B, S, H, dh).transpose(1, 2))
    return ctx.transpose(1, 2).reshape(B * K, D), w.mean(dim=1).reshape(B * K, S)


def check_beam_cross_attention(device: str, card: str) -> dict:
    """The one-query cross-attention kernel against its plain version at
    the fused beam step's shape (B = 128, K = 5, S = 80, D = 512, 8 heads)
    and at CROSS_EDGE_SHAPES, each with a ragged mask whose row 1 is fully
    masked (uniform weights) and with no mask, two launches bitwise equal;
    CROSS_KERNELS once each a call: the count from a captured graph's
    kernel nodes (``graph_launches``), the names from the profile."""
    result = {}
    for B, K, S, D, H, dtype in CROSS_EDGE_SHAPES + ((128, 5, 80, 512, 8, torch.float32),):
        layers = [beam_cross_inputs(device, B, K, S, D, seed=30 + i, dtype=dtype)
                  for i in range(2)]
        q, ck, cv, mask = layers[0]
        err, uniform = 0.0, 0.0
        for m in (mask, None):
            got = beam_cross_attention(q, ck, cv, m, H, K)
            again = beam_cross_attention(q, ck, cv, m, H, K)
            want = beam_cross_attention_reference(q, ck, cv, m, H, K)
            torch.cuda.synchronize()
            err = max(err, max((a - b).abs().max().item() for a, b in zip(got, want)))
            if m is not None:
                uniform = (got[1][K:2 * K] - 1.0 / S).abs().max().item()
            if not same_bits(got, again):
                raise AssertionError(f"beam_cross_attention B={B} K={K} S={S} D={D} h={H} "
                                     f"{dtype}: two launches on the same inputs differ")
        atol = CROSS_MAIN_ATOL if B == 128 else BEAM_ATTN_ATOL
        if not (err <= atol and uniform <= 1e-7):
            raise AssertionError(f"beam_cross_attention B={B} K={K} S={S} D={D} h={H} {dtype}: "
                                 f"max abs err {err:.3g} (tol {atol}), fully masked row "
                                 f"{uniform:.3g} from uniform")
        if B != 128:
            print(f"[kernels] beam_cross_attention B={B} K={K} S={S} D={D} h={H} {dtype}: "
                  f"within {BEAM_ATTN_ATOL} ({err:.3g}), ragged mask and none, masked row "
                  f"uniform, two launches bitwise equal")
            continue
        # The profiler's names (a dropped record can remove a name, never add
        # a wrong one); the count from a captured graph's kernel nodes.
        prof = kernel_profile(lambda: [beam_cross_attention(*a, H, K) for a in layers], 20)
        if not all(any(k in name for k in CROSS_KERNELS) for name in prof):
            raise AssertionError(f"beam_cross_attention launched {sorted(prof)}")
        launches_per_call = graph_launches(
            lambda: [beam_cross_attention(*a, H, K) for a in layers], 10) / len(layers)
        if launches_per_call != len(CROSS_KERNELS):
            raise AssertionError(f"beam_cross_attention: {launches_per_call} launches a call")
        dev = sum(t for _, t in prof.values()) / (20 * len(layers))
        ms = time_layers_ms(lambda *a: beam_cross_attention(*a, H, K), layers, calls=50)
        plain_ms = time_layers_ms(lambda *a: beam_cross_attention_reference(*a, H, K),
                                  layers, calls=20)

        def sdpa(q, ck, cv, mask):
            dh = D // H
            add = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(B, K, H, dh).transpose(1, 2), ck.reshape(B, S, H, dh).transpose(1, 2),
                cv.reshape(B, S, H, dh).transpose(1, 2), attn_mask=add)

        comp = beam_cross_composite(q, ck, cv, mask, H, K)
        comp_err = max((a - b).abs().max().item()
                       for a, b in zip(comp, beam_cross_attention_reference(q, ck, cv, mask, H, K)))
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   graph_ms=graph_ms(lambda: beam_cross_attention(q, ck, cv, mask, H, K)),
                   cold_graph_ms=graph_ms(_rotating(lambda *a: beam_cross_attention(*a, H, K),
                                                    layers), calls=10),
                   profiler_ms=dev,
                   library_ms=graph_ms(lambda: beam_cross_composite(q, ck, cv, mask, H, K)),
                   library_cold_ms=graph_ms(_rotating(
                       lambda *a: beam_cross_composite(*a, H, K), layers), calls=10),
                   sdpa_context_only_ms=graph_ms(lambda: sdpa(q, ck, cv, mask)),
                   **bound(nbytes=4 * (2 * B * S * D + B * S + 2 * B * K * D + B * K * S),
                           flops=4 * B * K * S * D, peak_flops=F32_FLOPS))
        print(f"[kernels] beam_cross_attention B={B} K={K} S={S} D={D} h={H} float32: max abs "
              f"err {err:.3g} (tol {CROSS_MAIN_ATOL}), masked row uniform within {uniform:.3g}, "
              f"two launches bitwise equal, {launches_per_call:g} launches a call ({sorted(prof)}); "
              f"kernel "
              f"{ms:.4f} ms (device {res['graph_ms']:.4f} ms by graph replay, "
              f"{res['cold_graph_ms']:.4f} ms with two layers' inputs in turn, profiler "
              f"{dev:.4f} ms), plain {plain_ms:.4f} ms, PyTorch composite (matmul, masked "
              f"softmax, matmul, head mean; max err {comp_err:.3g}) device "
              f"{res['library_ms']:.4f} ms ({res['library_cold_ms']:.4f} ms in turn), SDPA "
              f"(context only) device {res['sdpa_context_only_ms']:.4f} ms, bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}) ({card})")
        result["main"] = res
    # The main shape with bfloat16 K/V (the transformer_cross_kv_bf16 cache):
    # the kernel widens K/V exactly, so the library composite runs on their
    # float32 casts (the casts included in its time).
    B, K, S, D, H = 128, 5, 80, 512, 8
    q, ck, cv, mask = beam_cross_inputs(device, B, K, S, D, seed=30, dtype=torch.bfloat16)
    got = beam_cross_attention(q, ck, cv, mask, H, K)
    want = beam_cross_attention_reference(q, ck, cv, mask, H, K)
    sync(device)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if err > BEAM_ATTN_ATOL:
        raise AssertionError(f"beam_cross_attention bf16 K/V: max abs err {err:.3g}")
    bf16 = dict(max_abs_err=err,
                graph_ms=graph_ms(lambda: beam_cross_attention(q, ck, cv, mask, H, K)),
                plain_ms=time_ms(lambda: beam_cross_attention_reference(q, ck, cv, mask, H, K),
                                 calls=20),
                library_ms=graph_ms(lambda: beam_cross_composite(q, ck.float(), cv.float(),
                                                                 mask, H, K)),
                **bound(nbytes=2 * 2 * B * S * D + 4 * (B * S + 2 * B * K * D + B * K * S),
                        flops=4 * B * K * S * D, peak_flops=F32_FLOPS))
    print(f"[kernels] beam_cross_attention B={B} K={K} S={S} D={D} h={H} bf16 K/V: max abs err "
          f"{err:.3g} (tol {BEAM_ATTN_ATOL}); kernel device {bf16['graph_ms']:.4f} ms by graph "
          f"replay, plain {bf16['plain_ms']:.4f} ms, PyTorch composite on the float32 casts "
          f"(casts included) device {bf16['library_ms']:.4f} ms, bound {bf16['bound_ms']:.4f} "
          f"ms ({bf16['bound_by']}) ({card})")
    result["main"]["bf16"] = bf16
    result["main"]["bf16_query"] = check_beam_cross_attention_bf16q(device, card)
    return result["main"]


def check_beam_cross_attention_bf16q(device: str, card: str) -> dict:
    """The bfloat16-query form (the bfloat16 beam state's): context and
    head-mean weights in bfloat16 within BF16_ULP_TOL of the plain version
    at CROSS_EDGE_SHAPES (both K/V dtypes) and the main shape (bfloat16 K/V),
    ragged mask with row 1 fully masked (uniform weights) and none, two
    launches bitwise equal; two launches a call (captured graph); device
    time by graph replay beside the float32-query form's on the same K/V, the
    plain version's, the PyTorch composite in bfloat16, and the bound."""
    for B, K, S, D, H, dtype in CROSS_EDGE_SHAPES + ((128, 5, 80, 512, 8, torch.bfloat16),):
        q, ck, cv, mask = beam_cross_inputs(device, B, K, S, D, seed=30, dtype=dtype)
        q = q.to(torch.bfloat16)
        ulps = 0.0
        for m in (mask, None):
            got = beam_cross_attention(q, ck, cv, m, H, K)
            again = beam_cross_attention(q, ck, cv, m, H, K)
            want = beam_cross_attention_reference(q, ck, cv, m, H, K)
            sync(device)
            ulps = max([ulps] + [bf16_ulps(a, b, BEAM_ATTN_ATOL) for a, b in zip(got, want)])
            rounded = beam_cross_attention(q.float(), ck, cv, m, H, K)[0].to(torch.bfloat16)
            # A fully masked row's weights are one value (1/S, rounded).
            uniform = m is None or bool((got[1][K:2 * K] == got[1][K, 0]).all())
            if (not same_bits(got, again) or not uniform or not same_bits(got[0], rounded)
                    or any(o.dtype != torch.bfloat16 for o in got)):
                raise AssertionError(f"beam_cross_attention bf16 q B={B} K={K} S={S} D={D} "
                                     f"h={H} {dtype}: repeat bitwise {same_bits(got, again)}, "
                                     f"masked row uniform {uniform}, the float32 form's context "
                                     f"rounded {same_bits(got[0], rounded)}, dtypes "
                                     f"{[o.dtype for o in got]}")
        if not ulps <= BF16_ULP_TOL:
            raise AssertionError(f"beam_cross_attention bf16 q B={B} K={K} S={S} D={D} h={H} "
                                 f"{dtype} K/V: {ulps:g} bf16 ulps")
    print(f"[kernels] beam_cross_attention bf16 query at {len(CROSS_EDGE_SHAPES)} edge shapes "
          f"and the main one, ragged mask and none: within {BF16_ULP_TOL:g} bf16 ulp beyond "
          f"{BEAM_ATTN_ATOL}, the context the float32 form's bits rounded, masked row uniform, "
          f"two launches bitwise equal")
    B, K, S, D, H = 128, 5, 80, 512, 8
    q, ck, cv, mask = beam_cross_inputs(device, B, K, S, D, seed=30, dtype=torch.bfloat16)
    q16 = q.to(torch.bfloat16)
    got = beam_cross_attention(q16, ck, cv, mask, H, K)
    want = beam_cross_attention_reference(q16, ck, cv, mask, H, K)
    sync(device)
    launches = graph_launches(lambda: beam_cross_attention(q16, ck, cv, mask, H, K), 10)
    if launches != len(CROSS_KERNELS):
        raise AssertionError(f"beam_cross_attention bf16 q: {launches} launches a call")
    per_kernel = {next((k for k in ("head_mean_bf16", "beam_cross_attn") if k in name), name):
                  round(ms / 20, 5) for name, (_, ms)
                  in kernel_profile(lambda: beam_cross_attention(q16, ck, cv, mask, H, K),
                                    20).items()}
    res = dict(max_abs_err=max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)),
               max_bf16_ulps=max(bf16_ulps(a, b, BEAM_ATTN_ATOL) for a, b in zip(got, want)),
               max_bf16_ulps_raw=max(bf16_ulps(a, b) for a, b in zip(got, want)),
               ms=graph_ms(lambda: beam_cross_attention(q16, ck, cv, mask, H, K)),
               f32_query_ms=graph_ms(lambda: beam_cross_attention(q, ck, cv, mask, H, K)),
               plain_ms=time_ms(lambda: beam_cross_attention_reference(q16, ck, cv, mask, H, K),
                                calls=20),
               library_ms=graph_ms(lambda: beam_cross_composite(q16, ck, cv, mask, H, K)),
               **bound(nbytes=2 * 2 * B * S * D + 4 * B * S + 2 * 2 * B * K * D + 2 * B * K * S,
                       flops=4 * B * K * S * D, peak_flops=F32_FLOPS))
    print(f"[kernels] beam_cross_attention B={B} K={K} S={S} D={D} h={H} bf16 query, bf16 K/V: "
          f"max abs err {res['max_abs_err']:.3g}, {res['max_bf16_ulps']:g} bf16 ulps from the "
          f"plain version beyond {BEAM_ATTN_ATOL} ({res['max_bf16_ulps_raw']:g} without it; tol "
          f"{BF16_ULP_TOL:g}), "
          f"{launches:g} launches a call; kernel device {res['ms']:.4f} ms by graph replay "
          f"(float32 query on the same K/V {res['f32_query_ms']:.4f} ms), plain "
          f"{res['plain_ms']:.4f} ms, PyTorch composite in bf16 device {res['library_ms']:.4f} "
          f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); profiler ms a call by "
          f"kernel {per_kernel} ({card})")
    return res


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
            plan = card_plan(x, Cm) if device == "cuda" else None
            item = ("" if plan is None else
                    f"clusters of {plan['cluster']} CTAs of {plan['slice']} channels, "
                    f"{plan['active_clusters']} clusters at once, {plan['waves']} wave(s); ")
            tc = (f", {res['tf32x3_bound_ms']:.4f} ms (3xTF32 tensor cores, "
                  f"{res['tf32x3_bound_by']})" if f32 else "")
            print(f"[kernels] fused_bottleneck stage {stage} (B={B}, {H}x{H}, C={C}, Cm={Cm}) "
                  f"{dtype}: max err over the largest |output| {err:.3g} (tol "
                  f"{CNN_RTOL[dtype]}), two launches bitwise equal; {item}work item {plan}; kernel "
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


# matmul_bias_act's edge shapes (M, K, N) beside the small odd one: M not
# a multiple of the 32-row block (and several blocks a CTA), K not a
# multiple of 16, N not a multiple of 64; N past one 256-column block with
# K whose w streams in float32; K not a multiple of 4 (element-wise staging).
CONV1X1_EDGE_SHAPES = ((37, 13, 9), (20000, 40, 200), (1000, 24, 72), (333, 100, 300),
                       (50, 30, 64), (64, 256, 128))


def check_conv1x1(device: str, card: str) -> dict:
    """matmul_bias_act against its plain version at stage 1's conv3 (M =
    100352, K = 64, N = 256) with a residual, without one, and with
    relu=False and a residual; conv1x1 at stride 2 (a stage-2 downsample);
    CONV1X1_EDGE_SHAPES in float32 and bfloat16 with the three epilogues;
    every launch repeated and required bitwise equal. Device times by graph
    replay beside the F.linear + add + ReLU composite's and the bound."""
    g = torch.Generator(device="cpu").manual_seed(50)

    def inputs(M, K, N, dtype=torch.float32):
        t = (torch.randn((M, K), generator=g), torch.randn((N, K), generator=g) / K ** 0.5,
             torch.randn(N, generator=g) * 0.1, torch.randn((M, N), generator=g))
        return tuple(a.to(dtype).to(device) for a in t)

    def run(x, w, b, res, relu, what):
        got = matmul_bias_act(x, w, b, res, relu=relu)
        again = matmul_bias_act(x, w, b, res, relu=relu)
        want = matmul_bias_act_reference(x, w, b, res, relu=relu)
        sync(device)
        err = _rel_err(got, want)
        if not err <= CNN_RTOL[x.dtype] or not torch.equal(bits(got), bits(again)):
            raise AssertionError(f"matmul_bias_act {what}: err {err:.3g} (tol "
                                 f"{CNN_RTOL[x.dtype]}) or two launches differ")
        return got, want, err

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in CONV1X1_EDGE_SHAPES:
            x, w, b, r = inputs(M, K, N, dtype)
            for res, relu in ((r, True), (None, True), (r, False)):
                _, _, err = run(x, w, b, res, relu, f"({M}, {K}, {N}) {dtype}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    x, w, b, r = inputs(100352, 64, 256)
    result = None
    for name, res, relu in (("residual + relu", r, True), ("relu", None, True),
                            ("residual, relu=False", r, False)):
        got, want, err = run(x, w, b, res, relu, name)
        if not relu and not (got < 0).any():
            raise AssertionError(f"matmul_bias_act {name}: relu=False left no negative value")
        ms = time_ms(lambda: matmul_bias_act(x, w, b, res, relu=relu), calls=20)
        plain_ms = time_ms(lambda: matmul_bias_act_reference(x, w, b, res, relu=relu), calls=20)
        dev = graph_ms(lambda: matmul_bias_act(x, w, b, res, relu=relu))
        print(f"[kernels] matmul_bias_act (100352, 64) x (64, 256) {name} float32: max err over "
              f"the largest |output| {err:.3g}, two launches bitwise equal; kernel {ms:.4f} ms "
              f"(device {dev:.4f} ms by graph replay), plain {plain_ms:.4f} ms ({card})")
        if result is None:
            M, K = x.shape
            N = w.shape[0]

            def composite():
                return torch.relu(torch.nn.functional.linear(x, w, b) + r)

            result = dict(max_abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=plain_ms,
                          library_ms=graph_ms(composite), library_event_ms=time_ms(
                              composite, calls=20), device_ms=dev,
                          **bound(nbytes=4 * (M * K + N * K + N + 2 * M * N),
                                  flops=2 * M * K * N, peak_flops=F32_FLOPS, tf32x3=True))
            result["share_of_bound"] = result["bound_ms"] / dev
            print(f"[kernels] matmul_bias_act residual + relu: device {dev:.4f} ms by graph "
                  f"replay, bound {result['bound_ms']:.4f} ms ({result['bound_by']}; "
                  f"{result['share_of_bound']:.3f} of it reached), F.linear + add + relu (a "
                  f"3-call composite) device {result['library_ms']:.4f} ms by graph replay "
                  f"(event {result['library_event_ms']:.4f} ms) ({card})")
    x4 = torch.randn((32, 56, 56, 256), generator=g).to(device)
    w4, b4 = (torch.randn((512, 256), generator=g) / 16).to(device), torch.zeros(512, device=device)
    got = conv1x1(x4, w4, b4, stride=2, relu=False)
    again = conv1x1(x4, w4, b4, stride=2, relu=False)
    want = matmul_bias_act_reference(x4[:, ::2, ::2].reshape(-1, 256), w4, b4, relu=False)
    err = _rel_err(got.reshape(-1, 512), want)
    if (got.shape != (32, 28, 28, 512) or not err <= CNN_RTOL[torch.float32]
            or not torch.equal(got, again)):
        raise AssertionError(f"conv1x1 stride 2: {tuple(got.shape)}, err {err:.3g}, or two "
                             f"launches differ")
    print(f"[kernels] conv1x1 stride 2 (32, 56, 56, 256) -> (32, 28, 28, 512): err {err:.3g}; "
          f"{len(CONV1X1_EDGE_SHAPES)} edge shapes {CONV1X1_EDGE_SHAPES} in float32 and "
          f"bfloat16, three epilogues: worst errors { {str(k): v for k, v in worst.items()} } "
          f"(tol {CNN_RTOL}); every launch twice, bitwise equal")
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
# The same at B = 16: the tail batch of a clip's 80 frames (32 + 32 + 16).
INT8_TAIL_SHAPES = tuple((name, M // 2, K, N, int8_out, launches)
                         for name, M, K, N, int8_out, launches in INT8_FORWARD_SHAPES)


# The build whose requant divides every output.
INT8_DIVIDE_ALL = ("VCT_INT8_DIVIDE_ALL=1",)


def int8_plans(M: int, K: int, N: int, residual: bool, int8_out: bool) -> list:
    """Every plan the int8 launcher weighs on this card (``int8_candidates``
    on K as the wrapper pads it), its choice first."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return int8_candidates(M, K + (-K % 16), N, residual, int8_out, sms, int8_active_ctas(0))


def int8_plan_label(p: dict) -> str:
    return (f"tile {p['tile']} stages {p['stages']} grid {p['grid']} "
            f"({p['per_sm']} an SM, waves {p['waves']}, est {p['cost_us']:.1f} us)")


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
    At every odd shape both kernels also run under each plan the launcher
    weighs (``int8_plans``), forced in turn. Then the 17 shapes of one
    B = 32 forward, kernel against ``torch._int_mm``, both as CUDA-graph
    replays (device against device), each printed with its plan and its
    share of the bound, with each plan the launcher weighs and the build
    that divides every output forced in turn (each bitwise equal to its
    choice); then the same at B = 16 (``INT8_TAIL_SHAPES``, each plan
    forced, the launcher's choice beside the fastest). The returned entries
    time kernel and
    ``torch._int_mm`` alike, with CUDA events; the device times are
    printed."""
    s_out, s_id = 0.1, 0.03
    n_plans = 0
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
                want_res = _int8_equal("residual", (M, K, N), so, fn, ref)
                if x is not xq:
                    continue
                # Every plan the launcher weighs, forced in turn, for both kernels.
                want_req = _int8_calls("requant", xq, wq, scale, bias, idq, s_id, so)[1]()
                for name, want, res_in in (("requant", want_req, None),
                                           ("residual", want_res, idq)):
                    for p in int8_plans(M, K, N, res_in is not None, so is not None):
                        got = int8_launch(xq, wq, scale, bias, res_in, s_id, so, True, plan=p)
                        if not torch.equal(got, want):
                            raise AssertionError(f"int8 {name} ({M}, {K}, {N}) s_out={so} "
                                                 f"{int8_plan_label(p)}: differs from the plain "
                                                 f"version")
                        n_plans += 1
    print(f"[kernels] int8 kernels at {len(INT8_EDGE_SHAPES)} odd shapes "
          f"{list(INT8_EDGE_SHAPES)}, int8 out (s_out 0.1 and 0.004) and float32 out, relu on "
          f"and off, aligned and unaligned xq, both kernels under each of their plans forced "
          f"({n_plans} launches): equal to the plain versions, two launches bitwise equal")
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
    totals = {"kernel": 0.0, "bound": 0.0, "int_mm": 0.0, "divide": 0.0, "tail": 0.0,
              "tail_fastest": 0.0}
    for batch, name, M, K, N, int8_out, launches in (
            [(32, *shape) for shape in INT8_FORWARD_SHAPES]
            + [(16, *shape) for shape in INT8_TAIL_SHAPES]):
        xq, wq, scale, bias, idq = int8_inputs(device, M, K, N, seed=62)
        so = s_out if int8_out else None
        residual = name == "residual"
        fn, ref = _int8_calls(name, xq, wq, scale, bias, idq, s_id, so)
        _int8_equal(name, (M, K, N), so, fn, ref)
        got = fn()
        dev = graph_ms(fn)
        lib_dev = graph_ms(lambda: torch._int_mm(xq, wq.t()))
        b = _int8_bound(name, M, K, N, int8_out)
        plans = int8_plans(M, K, N, residual, int8_out)
        chosen = tuple(plans[0][k] for k in INT8_PLAN_KEYS)
        if int8_card_plan(M, K, N, residual, int8_out, 0) != chosen:
            raise AssertionError(f"int8 {name} ({M}, {K}, {N}): the launcher's plan is not the "
                                 f"first candidate")
        variants = [(int8_plan_label(p), dict(plan=p)) for p in plans]
        if int8_out and batch == 32:  # float32 out has no requant
            variants.append(("divide every output", dict(defines=INT8_DIVIDE_ALL)))
        forced = {}
        for label, kw in variants:
            call = lambda: int8_launch(  # noqa: E731
                xq, wq, scale, bias, idq if residual else None, s_id, so, True, **kw)
            if not torch.equal(call(), got):
                raise AssertionError(f"int8 {name} ({M}, {K}, {N}) {label}: differs from the "
                                     f"kernel")
            forced[label] = graph_ms(call)
        fastest = min(forced[int8_plan_label(p)] for p in plans)
        if batch == 32:
            totals["kernel"] += launches * dev
            totals["bound"] += launches * b["bound_ms"]
            totals["int_mm"] += launches * lib_dev
            totals["divide"] += launches * forced.get("divide every output", dev)
        else:
            totals["tail"] += launches * dev
            totals["tail_fastest"] += launches * fastest
        print(f"[kernels] int8 {'forward' if batch == 32 else 'tail-batch (B = 16)'} shape: "
              f"{name} ({M}, {K}, {N}) "
              f"{'int8' if int8_out else 'float32'} out x{launches}: kernel device {dev:.4f} ms "
              f"under {int8_plan_label(plans[0])}, torch._int_mm device {lib_dev:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {b['bound_ms'] / dev:.3f} of it "
              f"reached); fastest forced plan {fastest:.4f} ms; forced: "
              f"{'; '.join(f'{k}: {v:.4f}' for k, v in forced.items())} ({card})")
        del xq, wq, scale, bias, idq
    n = sum(s[-1] for s in INT8_FORWARD_SHAPES)
    print(f"[kernels] int8 forward, {n} launches at {len(INT8_FORWARD_SHAPES)} shapes "
          f"(sum of launches x device ms, CUDA graphs): kernels {totals['kernel']:.4f} ms, "
          f"bound {totals['bound']:.4f} ms ({totals['bound'] / totals['kernel']:.3f} of it "
          f"reached), torch._int_mm {totals['int_mm']:.4f} ms; with the divide on every output "
          f"{totals['divide']:.4f} ms; at B = 16 the launcher's plans {totals['tail']:.4f} ms, "
          f"the fastest forced plan at each shape {totals['tail_fastest']:.4f} ms ({card})")
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
            ("resnet50 fused bf16", "resnet50", "fused", "bfloat16", False),
            ("resnet50 folded bf16", "resnet50", "folded", "bfloat16", False)]


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
                for tag in ("", " bf16"):
                    fused, folded = (out["forward_ms"][f"resnet50 {v}{tag}"]
                                     for v in ("fused", "folded"))
                    print(f"[extract] one B={batch_size} ResNet50{tag} forward in this run: "
                          f"fused {fused:.3f} ms, folded {folded:.3f} ms (fused / folded "
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
        flags = "".join(f", {f}" for f in ("transformer_bf16_beam_state",
                                           "transformer_cross_kv_bf16") if getattr(k, f))
        return f"transformer, {'fused' if k.transformer_fused_beam_attn else 'default'}{flags}"
    attention = ("no attention" if not m.use_attention else
                 f"luong {m.luong_score}" if m.attention_type == "luong" else
                 f"multihead x{m.attention_num_heads}" if m.attention_type == "multihead" else "")
    return f"lstm{' ' + attention if attention else ''}, {'fused' if k.use_pallas_lstm else 'default'}"


GATE = beam_mod.fused_vocab_eligible


def gate_as_on_card(config, device, *args):
    """The fused-vocabulary gate evaluated as if the tensors were on the
    card, so a CPU reference run takes the card's branch."""
    return GATE(config, torch.device("cuda"), *args)


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


def encode_ms(predictor: VideoCaptionPredictor, clips: np.ndarray, config: Config) -> float:
    """CUDA-event time of the predictor's model encoding ``clips`` (all
    frames valid) under ``config``'s kernel flags."""
    feats = torch.from_numpy(np.ascontiguousarray(clips)).to(predictor.device)
    with torch.no_grad():
        return time_ms(lambda: encode(predictor.model, config, feats), calls=5)


def run_wide_encoder(card: str, clips: np.ndarray, device: str = "cuda") -> dict:
    """``encoder_hidden_dim = 1024``, inside the recurrence kernels' domain
    through their wide forms: 8 clips with beam 5 and one training step on
    ``device``, the encoder's log naming the kernel and its limit, one
    ``lstm_seq`` launch (the wide form) a layer, tokens equal to the CPU run
    (the gate evaluated as on the card: the plain versions), the step's loss
    and gradients within STEP_LOSS_RTOL / STEP_GRAD_RTOL with one wide
    ``lstm_seq_train`` forward and backward a layer; and the encode of the
    8 clips timed through the kernel and through the float32 scan (the
    ``use_pallas_lstm_seq`` flag off), in this call."""
    config = Config()
    config.model.encoder_hidden_dim = 1024
    config.validate()
    L = config.model.encoder_num_layers
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, config)
        with encoder_log() as lines:
            predictor = VideoCaptionPredictor(pkg, device=device)
            results, served = counted(device, "H=1024 beam-5 x 8",
                                      {"lstm_seq": L, "lstm_seq_wide": L, "topk2d_lse": 20},
                                 lambda: predictor.predict_batch(list(clips[:8]), method="beam",
                                                                 beam_size=5))
        with recurrence_gate_as_on_card():
            cpu = VideoCaptionPredictor(pkg, config=interpret_config(config),
                                        device="cpu").predict_batch(list(clips[:8]),
                                                                    method="beam", beam_size=5)
        timing = {}
        if device == "cuda":
            scan = Config.from_dict(predictor.config.to_dict())
            scan.kernels.use_pallas_lstm_seq = False
            timing["kernel_encode_ms"] = encode_ms(predictor, clips[:8], predictor.config)
            timing["scan_encode_ms"] = encode_ms(predictor, clips[:8], scan)
    share = agreement(results, cpu)
    gate_lines = [line for line in lines if "lstm_seq_eligible" in line]
    limit = kernel_max_hidden() if device == "cuda" else None
    print(f"[wide] encoder H=1024 served 8 clips on {device}: launches "
          f"{ {k: served[k] for k in ('lstm_seq', 'lstm_seq_wide', 'topk2d_lse')} }; tokens, "
          f"card vs CPU: agreement {share:.4f}; the encoder's log: {gate_lines}; encode of the "
          f"8 clips (2 layers): through lstm_seq {timing.get('kernel_encode_ms', 0.0):.4f} ms, "
          f"through the float32 scan {timing.get('scan_encode_ms', 0.0):.4f} ms ({card})")
    if share < 1.0 or (device == "cuda" and not any(
            "H=1024" in line and f"lstm_seq limit {limit}" in line and "lstm_scan" not in line
            for line in gate_lines)):
        raise AssertionError(f"wide encoder: agreement {share}, log {lines}")
    with encoder_log() as lines:
        parity = check_step_parity(card, config, device)
    n = parity["launches"]
    train_keys = ("lstm_seq", "lstm_seq_train_fwd", "lstm_seq_train_bwd",
                  "lstm_seq_train_fwd_wide", "lstm_seq_train_bwd_wide")
    print(f"[wide] one training step at H=1024: launches { {k: n[k] for k in train_keys} }; "
          f"the encoder's log: "
          f"{[line for line in lines if 'lstm_seq_eligible' in line]}; "
          f"{time.perf_counter() - t0:.1f} s wall in the phase ({card})")
    want = {"lstm_seq": 0, "lstm_seq_train_fwd": L, "lstm_seq_train_bwd": L,
            "lstm_seq_train_fwd_wide": L, "lstm_seq_train_bwd_wide": L}
    if device == "cuda" and ({k: n[k] for k in want} != want or not any(
            f"lstm_seq_train limit {limit}" in line and "lstm_scan" not in line
            for line in lines if "lstm_seq_eligible" in line)):
        raise AssertionError(f"wide encoder training step: launches {n}, log {lines}")
    return {"launches": {k: served[k] + n[k] for k in n}, "agreement": share,
            "loss_rel": parity["loss_rel"], **timing}


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

def bf16_transformer_arms() -> list:
    """(config, compute dtype) of each arm of ``run_bf16_transformer``:
    the transformer and its fused beam attention in bfloat16, the fused one
    with ``transformer_bf16_beam_state``, and with
    ``transformer_cross_kv_bf16`` in float32 and in bfloat16."""
    state = fused_transformer_config()
    state.kernels.transformer_bf16_beam_state = True
    cross = fused_transformer_config()
    cross.kernels.transformer_cross_kv_bf16 = True
    return [(transformer_config(), "bfloat16"), (fused_transformer_config(), "bfloat16"),
            (state, "bfloat16"), (cross, None), (cross, "bfloat16")]


def greedy_step_logits(predictor: VideoCaptionPredictor, feats: np.ndarray, tokens: list,
                       steps: int) -> torch.Tensor:
    """(steps, B, V) float32 logits of the predictor's greedy decode steps on
    ``feats`` (float32, as the live predictor is handed them), fed START and
    then ``tokens`` (B lists), on the CPU."""
    from video_captioning_tpu_torch.generation.families import make_decode_family

    model, config = predictor.model, predictor.config
    start = predictor.vocabulary.start_idx
    out = []
    with torch.inference_mode():
        x = torch.from_numpy(feats).to(predictor.device)
        enc, final, mask = encode(model, config, x)
        family = make_decode_family(model, config, enc, final, mask, num_beams=1,
                                    max_length=steps)
        state = family.state0
        prev = torch.full((len(tokens),), start, dtype=torch.int64, device=x.device)
        for t in range(steps):
            logits, state, _ = family.step(prev, state, t)
            out.append(logits.float().cpu())
            prev = torch.tensor([row[t] for row in tokens], dtype=torch.int64, device=x.device)
    return torch.stack(out)


def run_bf16_transformer(card: str, clips: np.ndarray, device: str = "cuda",
                         cpu_clips: int = 16, arms=None) -> dict:
    """The transformer family served in bfloat16 and with
    ``transformer_cross_kv_bf16`` (``bf16_transformer_arms``) at full width,
    from smoke_package's package (projection sharpened x3, END suppressed),
    greedy and beam-5 at B = 128: a beam search launches each beam-attention
    kernel once a decoder block and step in the fused arms (40 each) and
    ``topk2d_lse`` once a step, a greedy decode neither; each greedy step's
    logits on the first ``cpu_clips`` clips, teacher-forced along the CPU
    port's tokens, within BF16_LOGIT_RTOL of the CPU's (the float32 arm
    also gated by token agreement at MIN_CLIP_AGREEMENT, as the float32
    slices are); clip agreement with the CPU port's run in the same dtype
    on those clips and with the card's float32 run of the same kernels on
    all of them recorded; one encode + beam-5 of each arm profiled, and of
    the float32 runs."""
    steps = 20
    out = {"launches": {}, "agreement": {}, "profile": {}}
    batch = list(clips)
    f32_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, transformer_config())
        for config, dtype in arms or bf16_transformer_arms():
            label = f"{describe(config)}, {dtype or 'float32'}"
            fused = config.kernels.transformer_fused_beam_attn
            blocks = config.model.transformer_decoder_layers * steps
            card_p = VideoCaptionPredictor(pkg, config=config, device=device, compute_dtype=dtype)
            cpu_p = VideoCaptionPredictor(pkg, config=interpret_config(config), device="cpu",
                                          compute_dtype=dtype)
            plain = Config.from_dict(config.to_dict())
            for flag in ("transformer_bf16_beam_state", "transformer_cross_kv_bf16"):
                setattr(plain.kernels, flag, False)
            p32 = VideoCaptionPredictor(pkg, config=plain, device=device)
            out["agreement"][label] = {}
            for method in ("greedy", "beam"):
                attn = blocks if fused and method == "beam" else 0
                want = {"beam_self_attention": attn, "beam_cross_attention": attn,
                        "topk2d_lse": steps if method == "beam" else 0}
                got, n = counted(device, f"{label} {method} B={len(batch)}", want,
                                 lambda: card_p.predict_batch(batch, method=method, beam_size=5))
                out["launches"] = add_counts(out["launches"], n)
                cpu = cpu_p.predict_batch(batch[:cpu_clips], method=method, beam_size=5)
                key = (describe(plain), method)
                if key not in f32_runs:
                    f32_runs[key] = p32.predict_batch(batch, method=method, beam_size=5)
                vs_cpu, vs_f32 = agreement(got[:cpu_clips], cpu), agreement(got, f32_runs[key])
                out["agreement"][label][method] = {"card_vs_cpu": vs_cpu, "vs_f32": vs_f32}
                for i, r in enumerate(got):
                    _check_caption(r, config.model.vocab_size, f"{label} {method} clip {i}")
                print(f"[bf16 transformer] {label}: {method} B={len(batch)} on {device}: clip "
                      f"agreement with the CPU port's run (first {cpu_clips}) {vs_cpu:.4f}, with "
                      f"the card's float32 {describe(plain)} run {vs_f32:.4f}; first divergence "
                      f"vs CPU at {first_divergence(got[:cpu_clips], cpu)}; launches "
                      f"{ {k: n[k] for k in want} }")
            ref = [r["tokens"] for r in cpu_p.predict_batch(batch[:cpu_clips], method="greedy")]
            feats = np.stack(batch[:cpu_clips])
            cpu_logits = greedy_step_logits(cpu_p, feats, ref, steps)
            card_logits = greedy_step_logits(card_p, feats, ref, steps)
            live = torch.arange(cpu_logits.shape[-1]) != card_p.vocabulary.end_idx
            err = ((card_logits - cpu_logits)[..., live].abs().max()
                   / cpu_logits[..., live].abs().max()).item()
            out["agreement"][label]["greedy_logits_rel_err"] = err
            print(f"[bf16 transformer] {label}: greedy step logits, card against the CPU port "
                  f"teacher-forced along its tokens ({cpu_clips} clips, {steps} steps): max err "
                  f"{err:.3g} of the largest value (tol {BF16_LOGIT_RTOL})")
            if not err <= BF16_LOGIT_RTOL:
                raise AssertionError(f"{label}: greedy step logits {err:.3g} from the CPU's")
            vs_cpu = out["agreement"][label]["greedy"]["card_vs_cpu"]
            if dtype is None and vs_cpu < MIN_CLIP_AGREEMENT:
                raise AssertionError(f"{label}: greedy card vs CPU agreement {vs_cpu} < "
                                     f"{MIN_CLIP_AGREEMENT}")
            if device == "cuda":
                out["profile"][label] = profile_decode(card_p, batch, card)
                f32_label = f"{describe(plain)}, float32"
                if f32_label not in out["profile"]:
                    out["profile"][f32_label] = profile_decode(p32, batch, card)
    return out


class _AttentionRecorder:
    """While installed, the ``vct::`` attention ops of an exported program
    (``ops/library.py``, which reaches the wrappers through its handle on
    ``ops.transformer_attn``) call the wrappers through this recorder: it
    keeps (inputs, outputs) of the self-attention call at step ``last_t`` of
    each decoder layer and of the last cross-attention call, cloned when
    made (the program reuses its buffers), so that they can be held against
    the plain versions afterwards. The wrappers and their counts are
    untouched."""

    def __init__(self, last_t: int):
        from video_captioning_tpu_torch.ops import library
        from video_captioning_tpu_torch.ops import transformer_attn as ta

        self.library, self.ta, self.last_t = library, ta, last_t
        self.self_calls, self.cross_call = [], None

    def _self(self, q, k_lyr, v_lyr, anc, t, num_heads, num_beams):
        out = self.ta.beam_self_attention(q, k_lyr, v_lyr, anc, t, num_heads, num_beams)
        if t == self.last_t:
            self.self_calls.append(((q.clone(), k_lyr.clone(), v_lyr.clone(), anc.clone(), t,
                                     num_heads, num_beams), out.clone()))
        return out

    def _cross(self, q, ck, cv, mask, num_heads, num_beams):
        out = self.ta.beam_cross_attention(q, ck, cv, mask, num_heads, num_beams)
        self.cross_call = ((q.clone(), ck.clone(), cv.clone(),
                            None if mask is None else mask.clone(), num_heads, num_beams),
                           tuple(o.clone() for o in out))
        return out

    def __enter__(self):
        self.library.transformer_attn = types.SimpleNamespace(
            beam_self_attention=self._self, beam_cross_attention=self._cross)
        return self

    def __exit__(self, *exc):
        self.library.transformer_attn = self.ta

    def ulps(self) -> dict:
        """Each recorded call's largest distance from its plain version, in
        bfloat16 ulps beyond BEAM_ATTN_ATOL, and the query dtypes the kernels
        took."""
        ta = self.ta
        res = {"self": max(bf16_ulps(out, ta.beam_self_attention_reference(*args),
                                     BEAM_ATTN_ATOL) for args, out in self.self_calls),
               "cross": max(bf16_ulps(o, w, BEAM_ATTN_ATOL) for o, w in zip(
                   self.cross_call[1], ta.beam_cross_attention_reference(*self.cross_call[0])))}
        res["query_dtypes"] = sorted({str(a[0].dtype) for a, _ in self.self_calls}
                                     | {str(self.cross_call[0][0].dtype)})
        return res


def serve_spying_inputs(aot, batch: np.ndarray) -> tuple:
    """(records, the dtypes the artifact's program was handed) of one
    ``predict_batch`` call."""
    dtypes, load = [], aot._load_program

    def spying(table, bucket):
        program = load(table, bucket)

        def call(x):
            dtypes.append(x.dtype)
            return program(x)
        return call

    aot._load_program = spying
    try:
        return aot.predict_batch(batch), dtypes
    finally:
        del aot._load_program


def decode_features(predictor: VideoCaptionPredictor, feats: np.ndarray, dtype: torch.dtype,
                    method: str, steps: int) -> list:
    """Token lists of the predictor's model on ``feats`` cast to ``dtype``
    (what a ``.vcx`` of that compute dtype is handed): encode, then greedy
    or beam-5, as the exported serving program traced them."""
    from video_captioning_tpu_torch.generation.greedy import greedy_generate

    vocab, model, config = predictor.vocabulary, predictor.model, predictor.config
    with torch.inference_mode():
        x = torch.from_numpy(feats).to(dtype).to(predictor.device)
        enc, final, mask = encode(model, config, x)
        if method == "greedy":
            out = greedy_generate(model, config, enc, final, vocab.start_idx, vocab.end_idx,
                                  steps, mask)
        else:
            out = beam_mod.beam_search_generate(model, config, enc, final, vocab.start_idx,
                                                vocab.end_idx, steps, mask, beam_size=5)
    return out["generated_tokens"].cpu().tolist()


def run_bf16_export(card: str, clips: np.ndarray, device: str = "cuda",
                    cpu_clips: int = 16) -> dict:
    """bfloat16 serving artifacts (``cli.export --compute-dtype bfloat16``)
    on the card, bucket 128. ``Config()`` greedy: the program is handed
    bfloat16 features (ROADMAP C.7), launches ``lstm_seq`` once a layer,
    and gives the live model's tokens on the same bfloat16 features. The
    fused transformer with ``transformer_bf16_beam_state``, beam-5:
    bfloat16 features in, 40 launches of each beam-attention kernel and 20
    of ``topk2d_lse`` a call, the kernels' calls at the last step (every
    layer) and the last cross call taking a bfloat16 query and within
    BF16_ULP_TOL of the plain versions on the same inputs, the live model's
    tokens on the same card and bfloat16 features (ROADMAP C.10), and the
    card's tokens beside the CPU port's on the same bfloat16 features for
    the first ``cpu_clips`` clips (beam agreement recorded: bfloat16 beams
    part on near ties)."""
    from video_captioning_tpu_torch.cli import export as cli_export
    from video_captioning_tpu_torch.inference.export import ExportedPredictor

    steps = 20
    out = {"launches": {}, "export_s": {}, "agreement": {}}
    batch = np.stack(list(clips))
    with tempfile.TemporaryDirectory() as tmp:
        state = fused_transformer_config()
        state.kernels.transformer_bf16_beam_state = True
        for i, (config, method) in enumerate(((Config(), "greedy"), (state, "beam"))):
            label = describe(config)
            pkg = smoke_package(f"{tmp}/pkg{i}", config)
            t0 = time.perf_counter()
            vcx = cli_export.main(["--model-path", pkg, "--output", f"{tmp}/model{i}.vcx",
                                   "--batch-sizes", str(len(batch)), "--method", method,
                                   "--beam-size", "5", "--max-length", str(steps),
                                   "--compute-dtype", "bfloat16", "--platforms", device,
                                   "--log-level", "WARNING"])
            out["export_s"][label] = time.perf_counter() - t0
            aot = ExportedPredictor(vcx, device=device)
            if config.model.architecture == "lstm":
                want = {"lstm_seq": config.model.encoder_num_layers, "topk2d_lse": 0}
            else:
                blocks = config.model.transformer_decoder_layers * steps
                want = {"beam_self_attention": blocks, "beam_cross_attention": blocks,
                        "topk2d_lse": steps}
            (got, dtypes), n = counted(device, f"bf16 exported {label}", want,
                                       lambda: serve_spying_inputs(aot, batch))
            out["launches"] = add_counts(out["launches"], n)
            if dtypes != [torch.bfloat16]:
                raise AssertionError(f"bf16 exported {label}: the program was handed {dtypes}")
            for j, r in enumerate(got):
                _check_caption(r, config.model.vocab_size, f"bf16 exported {label} clip {j}")
            if config.model.architecture == "lstm":
                live = VideoCaptionPredictor(pkg, device=device, compute_dtype="bfloat16")
                if [r["tokens"] for r in got] != decode_features(live, batch, torch.bfloat16,
                                                                  method, steps):
                    raise AssertionError(f"bf16 exported {label}: tokens differ from the live "
                                         f"model's on the same bfloat16 features")
                print(f"[bf16 export] {label} greedy: the program was handed {dtypes}; tokens "
                      f"equal to the live bf16 model's on the same bfloat16 features for all "
                      f"{len(batch)} clips; launches { {k: n[k] for k in want} }; cli.export in "
                      f"{out['export_s'][label]:.1f} s")
                continue
            # On the card the program's vct:: ops run the wrappers (on the
            # CPU they run the plain versions, ops/library.py).
            ulps = {"self": 0.0, "cross": 0.0, "query_dtypes": "not recorded on the CPU"}
            if device == "cuda":
                with _AttentionRecorder(steps - 1) as rec:
                    aot.predict_batch(batch)
                    sync(device)
                ulps = rec.ulps()
                if (ulps["query_dtypes"] != ["torch.bfloat16"]
                        or max(ulps["self"], ulps["cross"]) > BF16_ULP_TOL):
                    raise AssertionError(f"bf16 exported {label}: kernels against the plain "
                                         f"versions on their recorded inputs {ulps}")
            # The program against the live bf16 model on the same card and
            # the same bfloat16 features (ROADMAP C.10), as the LSTM arm.
            live = VideoCaptionPredictor(pkg, config=config, device=device,
                                         compute_dtype="bfloat16")
            live_tokens = decode_features(live, batch, torch.bfloat16, method, steps)
            same_live = [r["tokens"] == t for r, t in zip(got, live_tokens)]
            out["agreement"][f"{label} vs live"] = sum(same_live) / len(same_live)
            if not all(same_live):
                diverge = first_divergence(got, [{"tokens": t} for t in live_tokens])
                raise AssertionError(f"bf16 exported {label}: tokens differ from the live "
                                     f"model's on the same bfloat16 features on "
                                     f"{len(diverge)} of {len(same_live)} clips, first at "
                                     f"{diverge}")
            cpu = VideoCaptionPredictor(pkg, config=interpret_config(config), device="cpu",
                                        compute_dtype="bfloat16")
            cpu_tokens = decode_features(cpu, batch[:cpu_clips], torch.bfloat16, method, steps)
            same = [r["tokens"] == t for r, t in zip(got, cpu_tokens)]
            out["agreement"][label] = sum(same) / len(same)
            out["kernels_bf16_ulps"] = ulps
            print(f"[bf16 export] {label} beam-5: the program was handed {dtypes}; tokens "
                  f"equal to the live bf16 model's on the same bfloat16 features for all "
                  f"{len(batch)} clips; launches "
                  f"{ {k: n[k] for k in want} }; its beam_self_attention calls at t = "
                  f"{steps - 1} and last beam_cross_attention call took a {ulps['query_dtypes']} "
                  f"query and lie within {max(ulps['self'], ulps['cross']):g} bf16 ulp (beyond "
                  f"{BEAM_ATTN_ATOL}) of the plain versions on the same inputs; clip agreement "
                  f"with the CPU port on the same bfloat16 features (first {cpu_clips}) "
                  f"{out['agreement'][label]:.4f}; cli.export in "
                  f"{out['export_s'][label]:.1f} s ({card})")
    return out


# bfloat16 training, card against the CPU port's bfloat16 step: the
# tolerances of tests/test_torch_bf16_train.py (the port against the JAX
# cast policy on the CPU): the loss relative, every gradient's max error
# over the largest gradient value of the step.
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD_RTOL = 2e-2


def check_lstm_train_bf16(device: str, card: str) -> dict:
    """Both ``lstm_seq_train`` launches on bfloat16 xproj (the bfloat16
    training step's) against their plain versions at (80, 2, 32, 2048), at
    (80, 2, 32, 4096) (the wide forms) and at LSTM_EDGE_SHAPES, each launched twice and required bitwise equal:
    the forward's float32 residuals (h_keep, c_keep) at the float32
    phase's LSTM_TRAIN_FWD_ATOL, its bfloat16 outputs (outs, h_last,
    c_last, gact) at lstm_seq's bfloat16 tolerance (a bfloat16 rounding of
    float32 values that agree within LSTM_TRAIN_FWD_ATOL), the backward at
    LSTM_TRAIN_BWD_RTOL of each output's largest value."""
    bf16 = torch.bfloat16
    fwd_names = ("outs", "h_last", "c_last", "gact", "h_keep", "c_keep")
    worst = {"fwd_bf16_outputs": 0.0, "fwd_f32_residuals": 0.0, "bwd": 0.0}
    shapes = [(80, 32, 512), (80, 32, 1024)] + list(LSTM_EDGE_SHAPES)
    full = {}
    for T, B, H in shapes:
        if T == 80:
            xproj, w, mask = lstm_inputs(device, bf16, T=T, B=B, H=H)
        else:
            xproj, w, mask = lstm_edge_inputs(device, bf16, T, B, H)
        got = lstm_seq_train_fwd(xproj, w, mask)
        again = lstm_seq_train_fwd(xproj, w, mask)
        want = lstm_seq_train_fwd_reference(xproj, w, mask)
        sync(device)
        err = {n: (a.float() - b.float()).abs().max().item()
               for n, a, b in zip(fwd_names, got, want)}
        e16 = max(err[n] for n in fwd_names[:4])
        e32 = max(err[n] for n in fwd_names[4:])
        if (e16 > LSTM_ATOL[bf16] or e32 > LSTM_TRAIN_FWD_ATOL or not same_bits(got, again)
                or any(a.dtype != b.dtype for a, b in zip(got, want))
                or got[0].dtype != bf16):
            raise AssertionError(f"lstm_seq_train_fwd bf16 xproj T={T} B={B} H={H}: max abs "
                                 f"err {err} (tol {LSTM_ATOL[bf16]} bf16, "
                                 f"{LSTM_TRAIN_FWD_ATOL} float32) or two launches differ")
        worst["fwd_bf16_outputs"] = max(worst["fwd_bf16_outputs"], e16)
        worst["fwd_f32_residuals"] = max(worst["fwd_f32_residuals"], e32)
        g = torch.Generator(device="cpu").manual_seed(4)
        douts = torch.randn((T, 2, B, H), generator=g).to(device, bf16)
        dh_last, dc_last = (torch.randn((2, B, H), generator=g).to(device, bf16)
                            for _ in range(2))
        res = want[3:]
        bgot = lstm_seq_train_bwd(*res, w, mask, douts, dh_last, dc_last)
        bagain = lstm_seq_train_bwd(*res, w, mask, douts, dh_last, dc_last)
        bwant = lstm_seq_train_bwd_reference(*res, w, mask, douts, dh_last, dc_last)
        sync(device)
        # dW_hh is all zeros at T = 1 (h_prev = 0): held absolutely there.
        rel = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1.0 if T == 1 else 0.0)).item()
                  for a, b in zip(bgot, bwant))
        if (rel > LSTM_TRAIN_BWD_RTOL or not same_bits(bgot, bagain)
                or bgot[0].dtype != bf16):
            raise AssertionError(f"lstm_seq_train_bwd bf16 xproj T={T} B={B} H={H}: max err "
                                 f"relative to the largest value {rel:.3g} (tol "
                                 f"{LSTM_TRAIN_BWD_RTOL}) or two launches differ")
        worst["bwd"] = max(worst["bwd"], rel)
        if T == 80:  # full width: the narrow form (H = 512) and the wide one (1024)
            main = full[H] = {
                "fwd_err": err, "bwd_rel": rel,
                "fwd_ms": time_ms(lambda: lstm_seq_train_fwd(xproj, w, mask), calls=5),
                "bwd_ms": time_ms(lambda: lstm_seq_train_bwd(*res, w, mask, douts, dh_last,
                                                             dc_last), calls=5)}
            print(f"[kernels] lstm_seq_train (80, 2, 32, {4 * H}) bfloat16 xproj: forward max abs "
                  f"err {err} (tol {LSTM_ATOL[bf16]} on the bf16 outputs, "
                  f"{LSTM_TRAIN_FWD_ATOL} on the float32 residuals); backward max err "
                  f"relative to the largest value {rel:.3g} (tol {LSTM_TRAIN_BWD_RTOL}); both "
                  f"launched twice bitwise equal; fwd {main['fwd_ms']:.4f} ms, bwd "
                  f"{main['bwd_ms']:.4f} ms from CUDA events ({card})")
    print(f"[kernels] lstm_seq_train on bfloat16 xproj at {len(LSTM_EDGE_SHAPES)} odd shapes: "
          f"worst errors {worst}, every launch twice bitwise equal ({card})")
    return dict(full[512], wide=full[1024], worst=worst)


@contextlib.contextmanager
def int_mm_counter():
    """Counts the ``torch._int_mm`` calls made in the block (the W8A8
    decode's products: a library GEMM, not a kernel of this port)."""
    calls = {"n": 0}
    real = torch._int_mm

    def counting(a, b):
        calls["n"] += 1
        return real(a, b)

    torch._int_mm = counting
    try:
        yield calls
    finally:
        torch._int_mm = real


def int8_step_products(config: Config, level: str) -> tuple:
    """(``_int_mm`` calls a decode step, calls once a decode): the vocabulary
    projection; at ``full`` in the transformer, each block's self-attention
    q, k, v (left split) and o, cross-attention q and o and the two MLP
    linears a step, and its cross-attention k and v once."""
    if level == "full" and config.model.architecture == "transformer":
        blocks = config.model.transformer_decoder_layers
        return 1 + 8 * blocks, 2 * blocks
    return 1, 0


def decode_weight_bytes(model: torch.nn.Module) -> dict:
    """Bytes of the decode linears that W8A8 replaces, as they are in
    ``model`` (int8 weights with float32 scales and biases) and in float32."""
    from video_captioning_tpu_torch.models.layers import Int8Linear

    q = [m for m in model.modules() if isinstance(m, Int8Linear)]
    held = sum(t.numel() * t.element_size() for m in q for t in m.buffers())
    f32 = sum(4 * (m.in_features + 1) * m.out_features for m in q)
    return {"int8": held, "float32": f32, "linears": len(q)}


# Whether the card's end-to-end int8 tokens must equal the CPU port's. At
# ``full`` the transformer quantizes the cross-attention keys and values of
# the float32 encoder's outputs, which the card and the CPU compute a few
# ulps apart (5.75e-06 of 4.8 on 8 clips, NVIDIA H100 80GB HBM3, 700.00 W);
# a round() near a half then lands one int8 step apart and the tokens can
# part (there, 5 of 8 clips equal at B = 8, 3 at B = 128). The int8
# linears themselves are bit-exact, and the card's decode of the CPU's
# encoder outputs must equal the CPU's at every level.
INT8_END_TO_END = {"vocab": True, "full": False}
INT8_CASES = (("default", "vocab", ("greedy", "beam")), ("fused", "vocab", ("beam", "greedy")),
              ("transformer", "full", ("beam",)), ("fused_transformer", "full", ("beam",)))


def int8_expected(config: Config, method: str, steps: int = 20) -> dict:
    """Launches of one decode of one batch with an int8 vocabulary: the
    encoder's lstm_seq, the hierarchical top-k in every beam step (never
    vocab_topk_lse), the fused cells and greedy attention under their flags,
    the transformer's beam attention kernels once per block a step."""
    k, m = config.kernels, config.model
    beam = method == "beam"
    if m.architecture == "transformer":
        fused = beam and k.transformer_fused_beam_attn
        per = m.transformer_decoder_layers * steps if fused else 0
        return {"topk2d_lse": steps if beam else 0, "beam_self_attention": per,
                "beam_cross_attention": per, "vocab_topk_lse": 0, "lstm_seq": 0}
    return {"lstm_seq": m.encoder_num_layers, "topk2d_lse": steps if beam else 0,
            "vocab_topk_lse": 0,
            "lstm_cell_fused": m.decoder_num_layers * steps if k.use_pallas_lstm else 0,
            "bahdanau_attend": steps if (k.use_pallas_attention and not beam) else 0}


def int8_linears_exact(card_model: torch.nn.Module, cpu_model: torch.nn.Module, device: str,
                       rows: int = 640) -> int:
    """Each W8A8 linear of the card's model against the CPU's on the same
    seeded (rows, in) input: the number of output entries whose bits
    differ, summed (the int32 products are exact and the dequant rounds
    the same on both)."""
    from video_captioning_tpu_torch.models.layers import Int8Linear, int8_linear

    g = torch.Generator(device="cpu").manual_seed(11)
    cpu_mods = dict(cpu_model.named_modules())
    differ = 0
    for name, mod in card_model.named_modules():
        if isinstance(mod, Int8Linear):
            x = torch.randn((rows, mod.in_features), generator=g) * 3.0
            got = int8_linear(mod, x.to(device)).cpu()
            differ += int((bits(got) != bits(int8_linear(cpu_mods[name], x))).sum())
    return differ


def decode_tokens(predictor: VideoCaptionPredictor, enc, final, mask, method: str) -> list:
    """Token lists of a greedy or beam-5 decode of 20 steps from the given
    encoder outputs, on the predictor's model and device."""
    from video_captioning_tpu_torch.generation.greedy import greedy_generate

    dev, vocab, config = predictor.device, predictor.vocabulary, predictor.config
    args = (predictor.model, config, enc.to(dev), final.to(dev), vocab.start_idx, vocab.end_idx,
            20, mask.to(dev))
    with torch.inference_mode():
        out = (beam_mod.beam_search_generate(*args, beam_size=5) if method == "beam"
               else greedy_generate(*args))
    return [{"tokens": t} for t in out["generated_tokens"].cpu().tolist()]


def run_int8_decode(card: str, clips: np.ndarray, device: str = "cuda",
                    cpu_clips: int = 8) -> dict:
    """W8A8 decode (``decode_int8``) at full width on a B = 128 batch, the
    package of smoke_package (projection sharpened x3, END suppressed): the
    LSTM default at ``vocab`` (greedy, beam-5), its fused decode step at
    ``vocab`` (beam-5, greedy), the transformer and its fused beam attention
    at ``full`` (beam-5). Each: launches and ``_int_mm`` calls exactly as
    implied (no vocab_topk_lse with an int8 vocabulary); every int8 linear
    bit for bit equal to the CPU's on the same input; the card's decode of
    the CPU run's encoder outputs equal, token for token, to the CPU's on
    the first ``cpu_clips`` clips; the end-to-end card-vs-CPU agreement of
    those clips (required 1 at ``vocab``; recorded at ``full``, see
    INT8_END_TO_END); int8 against float32 agreement on the card for all
    clips; the decode weights' bytes; and encode + beam-5 profiled beside
    float32."""
    configs = {"default": Config, "fused": fused_config, "transformer": transformer_config,
               "fused_transformer": fused_transformer_config}
    batch = list(clips)
    out = {"launches": {}, "cases": {}}
    t0 = time.perf_counter()
    for name, level, methods in INT8_CASES:
        config = configs[name]()
        with tempfile.TemporaryDirectory() as tmp:
            pkg = smoke_package(tmp, config)
            pq = VideoCaptionPredictor(pkg, device=device, decode_int8=level)
            p32 = VideoCaptionPredictor(pkg, device=device)
            cpu = VideoCaptionPredictor(pkg, config=interpret_config(config), device="cpu",
                                        decode_int8=level)
            wbytes = decode_weight_bytes(pq.model)
            differ = int8_linears_exact(pq.model, cpu.model, device)
            print(f"[int8] {describe(config)} at {level}: {wbytes['linears']} decode linears "
                  f"held in {wbytes['int8']} bytes (int8 weights, float32 scales and biases) "
                  f"against {wbytes['float32']} bytes in float32; on the same 640-row inputs "
                  f"{differ} output entries differ in bits from the CPU's")
            if differ:
                raise AssertionError(f"int8 {name}: {differ} int8 linear outputs differ")
            feats = torch.from_numpy(np.stack([cpu._prepare_features(c)
                                               for c in batch[:cpu_clips]]))
            with torch.inference_mode():
                cpu_enc = encode(cpu.model, cpu.config, feats)
            per_step, per_decode = int8_step_products(config, level)
            for method in methods:
                want = int8_expected(config, method)
                with int_mm_counter() as mm:
                    got, n = counted(device, f"int8 {name} {level} {method}", want,
                                     lambda: pq.predict_batch(batch, method=method,
                                                              beam_size=5))
                want_mm = 20 * per_step + per_decode
                if mm["n"] != want_mm:
                    raise AssertionError(f"int8 {name} {method}: {mm['n']} _int_mm calls, "
                                         f"want {want_mm}")
                out["launches"] = add_counts(out["launches"], n)
                ref32 = p32.predict_batch(batch, method=method, beam_size=5)
                beam_mod.fused_vocab_eligible = gate_as_on_card
                try:
                    cpu_res = cpu.predict_batch(batch[:cpu_clips], method=method, beam_size=5)
                    cpu_dec = decode_tokens(cpu, *cpu_enc, method)
                finally:
                    beam_mod.fused_vocab_eligible = GATE
                card_dec = decode_tokens(pq, *cpu_enc, method)
                same_decode = agreement(card_dec, cpu_dec)
                vs_cpu = agreement(got[:cpu_clips], cpu_res)
                vs_f32 = agreement(got, ref32)
                out["cases"][f"{name}/{level}/{method}"] = {
                    "decode_vs_cpu": same_decode, "card_vs_cpu": vs_cpu, "int8_vs_f32": vs_f32,
                    "int_mm": mm["n"], "weight_bytes": wbytes}
                print(f"[int8] {describe(config)} {level} {method} B={len(batch)} on {device}: "
                      f"decode of the CPU's encoder outputs, tokens equal to the CPU's for the "
                      f"first {cpu_clips} clips: {same_decode:.4f}; end to end, card vs CPU: "
                      f"{vs_cpu:.4f}; int8 vs float32 clip agreement on {device} {vs_f32:.4f} "
                      f"(first divergence at {first_divergence(got, ref32)[:12]}); launches "
                      f"{ {k: n[k] for k in want} }, _int_mm {mm['n']} "
                      f"({per_step} a step + {per_decode})")
                if same_decode < 1.0 or (INT8_END_TO_END[level] and vs_cpu < 1.0):
                    raise AssertionError(f"int8 {name} {level} {method}: decode tokens "
                                         f"{same_decode}, end to end {vs_cpu}")
            if device == "cuda":
                out["cases"][f"{name}/{level}/profile"] = {
                    "int8": profile_decode(pq, batch, card),
                    "float32": profile_decode(p32, batch, card)}
    print(f"[int8] phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return out


def _bf16_step(config: Config, device: str, batch: dict) -> tuple:
    """Loss and gradients of one bfloat16 step of the trainer's cast policy
    on ``device``, dropout off."""
    config = Config.from_dict(config.to_dict())
    config.experiment.use_tensorboard = False
    with tempfile.TemporaryDirectory() as tmp:
        config.experiment.checkpoint_dir = Path(tmp)
        trainer = VideoCaptioningTrainer(_model(config, device), config, Vocabulary(config),
                                         None, None, device=device)
    trainer.generator = None
    b = trainer._place(batch)
    with trainer.compute_weights():
        loss = trainer._loss(trainer.model, b["video_features"], b["input_tokens"],
                             b["target_tokens"], train=True)
        loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in trainer.model.named_parameters()}


def check_bf16_step_parity(card: str, config: Config, device: str = "cuda", B: int = 8) -> dict:
    """One bfloat16 step at full width on the card (the kernels) and on the
    CPU with ``kernels.interpret`` (their plain versions): the loss within
    BF16_STEP_LOSS_RTOL, every gradient within BF16_STEP_GRAD_RTOL of the
    largest gradient value."""
    batch = _step_batch(config, B, seed=5)
    reset_launch_counts()
    loss_gpu, g_gpu = _bf16_step(config, device, batch)
    sync(device)
    launches = launch_counts()
    with recurrence_gate_as_on_card():
        loss_cpu, g_cpu = _bf16_step(interpret_config(config), "cpu", batch)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    top = max(g.abs().max().item() for g in g_cpu.values())
    errs = {n: (g_gpu[n] - g).abs().max().item() / top for n, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    print(f"[bf16-train] step parity B={B}, card vs CPU plain versions, bfloat16: loss "
          f"{loss_gpu:.6f} vs {loss_cpu:.6f} (rel {loss_rel:.3g}, tol {BF16_STEP_LOSS_RTOL}); "
          f"worst gradient {worst} max err {errs[worst]:.3g} of the largest gradient value "
          f"(tol {BF16_STEP_GRAD_RTOL}); launches "
          f"{ {k: launches[k] for k in ('lstm_seq_train_fwd', 'lstm_seq_train_bwd')} }")
    if loss_rel > BF16_STEP_LOSS_RTOL or errs[worst] > BF16_STEP_GRAD_RTOL:
        raise AssertionError(f"bf16 step parity: loss rel {loss_rel:.3g}, {worst} "
                             f"{errs[worst]:.3g}")
    return {"loss_rel": loss_rel, "grad_rel": errs[worst], "launches": launches}


def run_bf16_training(card: str, device: str = "cuda", n_clips: int = 96) -> dict:
    """bfloat16 training of ``Config()`` at full width: the recurrence
    kernels checked on bfloat16 xproj first, then ``cli.train
    --compute-dtype bfloat16 --profile-dir`` for 2 epochs at B = 32 on
    ``n_clips`` seeded clips, through the native batch loader. Checked: the
    library built; every batch from the native path; lstm_seq_train
    launched on bfloat16 xproj, twice a step each way, and lstm_seq in
    validation; the trace written; finite losses; then one step at B = 8
    against the CPU, and one step at B = 32 profiled beside float32."""
    from video_captioning_tpu_torch import native

    # The module (the package exports a function of the same name).
    lst_mod = importlib.import_module("video_captioning_tpu_torch.ops.lstm_seq_train")

    out = {"kernels": check_lstm_train_bf16(device, card) if device == "cuda" else None}
    if not native.native_available():
        raise AssertionError("the native batch loader did not build")
    config = Config()
    config.training.compute_dtype = "bfloat16"
    config.data.vocab_threshold = 1
    config.validate()
    # The xproj dtype of each lstm_seq_train_fwd launch, read where the
    # wrapper fetches the library for it.
    dtypes = []
    real_lib = lst_mod._cuda_lib

    def recording_lib(x, what):
        if what == "lstm_seq_train_fwd":
            dtypes.append(x.dtype)
        return real_lib(x, what)

    cwd = os.getcwd()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            csv_path = training_data(Path(tmp), config, n_clips)
            cfg_path = Path(tmp) / "config.json"
            cfg_path.write_text(json.dumps(config.to_dict()))
            reset_launch_counts()
            lst_mod._cuda_lib = recording_lib
            try:
                t1 = time.perf_counter()
                trainer = cli_train.main(["--config", str(cfg_path), "--data-file",
                                          str(csv_path), "--checkpoint-dir", "ck", "--epochs",
                                          "2", "--device", device, "--compute-dtype",
                                          "bfloat16", "--profile-dir", "prof", "--log-level",
                                          "WARNING"])
                sync(device)
            finally:
                lst_mod._cuda_lib = real_lib
            out["launches"] = launch_counts()
            out["wall_s"] = time.perf_counter() - t1
            results = json.loads(Path("ck/training_results.json").read_text())
            steps = trainer.global_step
            train_ds, val_ds = trainer.train_loader.dataset, trainer.val_loader.dataset
            n_batches = 2 * len(trainer.train_loader) + len(results["val_history"]) * len(
                trainer.val_loader)
            native_batches = train_ds.native_batches + val_ds.native_batches
            losses = ([h["loss"] for h in results["train_history"]]
                      + [h["loss"] for h in results["val_history"]])
            trace = Path("prof/trace_epoch0.pt.trace.json")
            n = out["launches"]
            print(f"[bf16-train] cli.train --compute-dtype bfloat16, 2 epochs, {steps} steps at "
                  f"B={config.training.batch_size} on {device}: {out['wall_s']:.1f} s wall "
                  f"({card}; one call, not a benchmark); train losses "
                  f"{[h['loss'] for h in results['train_history']]}, val losses "
                  f"{[h['loss'] for h in results['val_history']]}; {native_batches} of "
                  f"{n_batches} batches from the native loader; lstm_seq_train_fwd xproj dtypes "
                  f"{sorted(set(str(d) for d in dtypes))}; trace "
                  f"{trace.stat().st_size if trace.exists() else 0} bytes; launches "
                  f"{ {k: n[k] for k in ('lstm_seq', 'lstm_seq_train_fwd', 'lstm_seq_train_bwd')} }")
            # Validation encodes each batch twice: its loss and its greedy decode.
            L = config.model.encoder_num_layers
            want = {"lstm_seq_train_fwd": L * steps, "lstm_seq_train_bwd": L * steps,
                    "lstm_seq": 2 * L * len(results["val_history"]) * len(trainer.val_loader)}
            bad = [
                (steps > 0 and all(np.isfinite(losses)), f"losses {losses}"),
                (native_batches == n_batches, f"{native_batches} of {n_batches} native"),
                (trace.exists(), "no trace"),
                (trainer.compute_dtype == torch.bfloat16, "not bfloat16"),
            ]
            if device == "cuda":
                bad += [({k: n[k] for k in want} == want, f"launches {n}, want {want}"),
                        (bool(dtypes) and set(dtypes) == {torch.bfloat16},
                         f"xproj dtypes {set(dtypes)}")]
            failed = [what for ok, what in bad if not ok]
            if failed:
                raise AssertionError(f"bf16 training: {failed}")
        finally:
            os.chdir(cwd)
    parity = check_bf16_step_parity(card, config, device)
    out["parity"] = {k: parity[k] for k in ("loss_rel", "grad_rel")}
    out["launches"] = add_counts(out["launches"], parity["launches"])
    if device == "cuda":
        out["profile"] = {}
        for dtype in ("bfloat16", "float32"):
            cfg = Config.from_dict(config.to_dict())
            cfg.training.compute_dtype = dtype
            cfg.experiment.use_tensorboard = False
            with tempfile.TemporaryDirectory() as tmp:
                cfg.experiment.checkpoint_dir = Path(tmp)
                trainer = VideoCaptioningTrainer(_model(cfg, device), cfg, Vocabulary(cfg),
                                                 None, None, device=device)
                print(f"[bf16-train] compute dtype {dtype}:")
                out["profile"][dtype] = profile_train_step(
                    trainer, _step_batch(cfg, cfg.training.batch_size, seed=7), card)
    print(f"[bf16-train] phase: {time.perf_counter() - t0:.1f} s wall ({card})")
    return out


# ----------------------------------------------------------------------------
# bfloat16 under the fused decode-step flags
# ----------------------------------------------------------------------------


def run_bf16_fused(card: str, clips: np.ndarray, device: str = "cuda",
                   cpu_clips: int = 16) -> dict:
    """``fused_config()`` served with ``compute_dtype="bfloat16"`` (the
    wrappers cast as the JAX ones do: float32 operands for ``lstm_cell`` and
    ``bahdanau_attend``, bf16 x for ``vocab_topk_lse``), greedy and beam-5 at
    B = 128 (smoke_package's protocol): a greedy decode launches
    ``bahdanau_attend`` once a step and ``lstm_cell`` once a layer and step,
    a beam search ``lstm_cell`` as often and ``vocab_topk_lse`` once a
    step; clip agreement with the CPU port's bfloat16 run on the first
    ``cpu_clips`` clips (greedy gated at MIN_BF16_GREEDY_AGREEMENT, beam
    recorded), and encode + beam-5 profiled beside float32."""
    config = fused_config()
    L, steps = config.model.encoder_num_layers, 20
    cells = config.model.decoder_num_layers * steps
    out = {"launches": {}, "agreement": {}, "profile": {}}
    batch = list(clips)
    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, config)
        p16 = VideoCaptionPredictor(pkg, device=device, compute_dtype="bfloat16")
        p32 = VideoCaptionPredictor(pkg, device=device)
        cpu16 = VideoCaptionPredictor(pkg, config=interpret_config(config), device="cpu",
                                      compute_dtype="bfloat16")
        wants = (("greedy", {"lstm_seq": L, "lstm_cell_fused": cells, "bahdanau_attend": steps,
                             "vocab_topk_lse": 0, "topk2d_lse": 0}),
                 ("beam", {"lstm_seq": L, "lstm_cell_fused": cells, "bahdanau_attend": 0,
                           "vocab_topk_lse": steps, "topk2d_lse": 0}))
        for method, want in wants:
            card16, n = counted(device, f"bf16 fused {method} B={len(batch)}", want,
                                lambda: p16.predict_batch(batch, method=method, beam_size=5))
            out["launches"] = add_counts(out["launches"], n)
            beam_mod.fused_vocab_eligible = gate_as_on_card
            try:
                cpu = cpu16.predict_batch(batch[:cpu_clips], method=method, beam_size=5)
            finally:
                beam_mod.fused_vocab_eligible = GATE
            card32 = p32.predict_batch(batch, method=method, beam_size=5)
            vs_cpu, vs_f32 = agreement(card16[:cpu_clips], cpu), agreement(card16, card32)
            out["agreement"][method] = {"card_vs_cpu_bf16": vs_cpu, "bf16_vs_f32": vs_f32}
            print(f"[bf16 fused] {method} B={len(batch)} on {device}: clip agreement with the "
                  f"CPU port's bf16 run (first {cpu_clips}) {vs_cpu:.4f}, with the card's "
                  f"float32 fused run {vs_f32:.4f}; first divergence vs CPU at "
                  f"{first_divergence(card16[:cpu_clips], cpu)}; launches "
                  f"{ {k: n[k] for k in want} }")
        if out["agreement"]["greedy"]["card_vs_cpu_bf16"] < MIN_BF16_GREEDY_AGREEMENT:
            raise AssertionError(f"bf16 fused greedy card vs CPU agreement "
                                 f"{out['agreement']['greedy']} < {MIN_BF16_GREEDY_AGREEMENT}")
        if device == "cuda":
            out["profile"]["bfloat16"] = profile_decode(p16, batch, card)
            out["profile"]["float32"] = profile_decode(p32, batch, card)
    return out


# ----------------------------------------------------------------------------
# The exported serving artifact
# ----------------------------------------------------------------------------


def profile_window(window, label: str, card: str) -> dict:
    """One-off, not a benchmark: CUDA-event time of ``window`` (median of
    3) and torch.profiler's device-busy time of one more."""
    from torch.profiler import ProfilerActivity, profile

    window_ms = time_ms(window, calls=1, runs=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        window()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[profile] {label} (one-off, not a benchmark; {card}): {window_ms:.3f} ms from CUDA "
          f"events; device busy {busy:.3f} ms, idle share {1 - busy / window_ms:.3f}")
    return {"window_ms": window_ms, "device_busy_ms": busy}


def run_export(card: str, clips: np.ndarray, device: str = "cuda") -> dict:
    """``cli.export`` on the card: the LSTM default (buckets 8 and 128) and
    the fused transformer (bucket 128), beam-5; ``ExportedPredictor`` serves
    100 clips (padded to 128) and 8, every clip's tokens equal to the live
    predictor's on the card, the program's kernel launches counted (2
    ``lstm_seq`` and 20 ``topk2d_lse`` a call; the fused transformer's two
    attention kernels once a decoder block and step), and the exported
    encode + beam-5 timed and profiled beside the live predictor's."""
    from video_captioning_tpu_torch.cli import export as cli_export
    from video_captioning_tpu_torch.inference.export import ExportedPredictor

    out = {"launches": {}, "export_s": {}, "profile": {}}
    steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        for i, (config, buckets) in enumerate(((Config(), "8,128"),
                                               (fused_transformer_config(), "128"))):
            label = describe(config)
            pkg = smoke_package(tmp, config)
            t0 = time.perf_counter()
            vcx = cli_export.main(["--model-path", pkg, "--output", f"{tmp}/model{i}.vcx",
                                   "--batch-sizes", buckets, "--method", "beam",
                                   "--beam-size", "5", "--max-length", str(steps),
                                   "--platforms", device, "--log-level", "WARNING"])
            out["export_s"][label] = time.perf_counter() - t0
            aot = ExportedPredictor(vcx, device=device)
            live = VideoCaptionPredictor(pkg, device=device)
            if config.model.architecture == "transformer":
                blocks = config.model.transformer_decoder_layers * steps
                want = {"beam_self_attention": blocks, "beam_cross_attention": blocks,
                        "topk2d_lse": steps}
            else:
                want = {"lstm_seq": config.model.encoder_num_layers, "topk2d_lse": steps}
            for n_clips in ((100, 8) if "," in buckets else (100,)):
                batch = list(clips[:n_clips])
                got, n = counted(device, f"exported {label} B={n_clips}", want,
                                 lambda: aot.predict_batch(batch))
                out["launches"] = add_counts(out["launches"], n)
                ref = live.predict_batch(batch, method="beam", beam_size=5, max_length=steps)
                if [r["tokens"] for r in got] != [r["tokens"] for r in ref]:
                    raise AssertionError(f"exported {label}: tokens differ from the live "
                                         f"predictor at {first_divergence(got, ref)}")
                for i, r in enumerate(got):
                    _check_caption(r, config.model.vocab_size, f"exported clip {i}")
                print(f"[export] {label}: {n_clips} clips served by the exported program "
                      f"(bucket {aot._bucket_in(aot.batch_sizes, n_clips)}), tokens equal to "
                      f"the live predictor's on every clip; launches "
                      f"{ {k: n[k] for k in want} }")
            print(f"[export] {label}: cli.export of buckets {buckets} on {device} in "
                  f"{out['export_s'][label]:.1f} s; artifact "
                  f"{Path(vcx).stat().st_size / 2**20:.1f} MiB")
            if device == "cuda":
                feats = torch.from_numpy(np.stack(list(clips))).cuda()
                program = aot._load_program("programs", 128)
                vocab = live.vocabulary

                @torch.inference_mode()
                def live_window():
                    enc, final, mask = encode(live.model, live.config, feats)
                    return beam_mod.beam_search_generate(live.model, live.config, enc, final,
                                                         vocab.start_idx, vocab.end_idx, steps,
                                                         mask, beam_size=5)

                @torch.inference_mode()
                def exported_window():
                    return program(feats)

                out["profile"][label] = {
                    "exported": profile_window(exported_window, f"{label}, exported encode + "
                                               f"beam-5 at B=128", card),
                    "live": profile_window(live_window, f"{label}, live encode + beam-5 at "
                                           f"B=128", card)}
    return out


# ----------------------------------------------------------------------------
# Data-parallel training and serving, the orbax (DCP) backend
# ----------------------------------------------------------------------------


def _grads(trainer: VideoCaptioningTrainer) -> dict:
    return {n: p.grad.detach().clone() for n, p in zip(trainer.trainable_names,
                                                        trainer.trainable)}


def dp_step_rank(rank: int, world: int, config_dict: dict, batch: dict) -> dict:
    """One data-parallel step of ``world`` NCCL ranks (rank r on card r):
    this rank's rows of ``batch``; returns the loss and the gradients."""
    from video_captioning_tpu_torch.parallel import make_mesh, shard_batch

    config = Config.from_dict(config_dict)
    mesh = make_mesh(config)
    trainer = VideoCaptioningTrainer(_model(config, f"cuda:{rank}"), config,
                                     Vocabulary(config), None, None, device=f"cuda:{rank}",
                                     mesh=mesh)
    trainer.generator = None
    loss = trainer.train_step(shard_batch(mesh, batch))
    return {"loss": loss.item(), "grads": {k: v.cpu() for k, v in _grads(trainer).items()}}


def _compare_steps(what: str, got_loss: float, got: dict, want_loss: float, want: dict) -> dict:
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    top = max(g.abs().max().item() for g in want.values())
    worst = max(((g.cpu() - want[n].cpu()).abs().max().item() / top, n) for n, g in got.items())
    print(f"[parallel] {what}: loss {got_loss:.7f} vs {want_loss:.7f} (rel {loss_rel:.3g}, tol "
          f"{DP_LOSS_RTOL}); worst gradient {worst[1]} {worst[0]:.3g} of the largest gradient "
          f"value (tol {DP_GRAD_RTOL}) over {len(got)} tensors")
    if loss_rel > DP_LOSS_RTOL or worst[0] > DP_GRAD_RTOL:
        raise AssertionError(f"{what}: loss rel {loss_rel:.3g}, {worst}")
    return {"loss_rel": loss_rel, "grad_rel": worst[0]}


def run_parallel(card: str, clips: np.ndarray, device: str = "cuda") -> dict:
    """Data parallelism on the card: a one-rank NCCL process group whose DP
    step at B = 32 (the loss's token count and the gradients all-reduced
    over the data group) equals the step without a process group (loss and
    every gradient) and launches both ``lstm_seq_train`` kernels;
    ``cli.serve --data-parallel`` (a subprocess) answering ``/caption``
    requests with the tokens of a predictor without a mesh; the orbax
    backend (torch.distributed.checkpoint) through ``cli.train`` for 2
    epochs, resumed once, the restored parameters and Adam moments equal to
    the trained ones; and, with two or more cards, the DP step across 2
    NCCL ranks."""
    import socket

    import torch.distributed as dist

    from video_captioning_tpu_torch.parallel import make_mesh
    from video_captioning_tpu_torch.parallel.multihost import spawn_ranks

    config = Config()
    m = config.model
    m.encoder_dropout = m.decoder_dropout = 0.0
    L = config.model.encoder_num_layers
    batch = _step_batch(config, 32, seed=11)
    out = {"launches": {}}

    def step(mesh=None):
        trainer = VideoCaptioningTrainer(_model(config, device), config, Vocabulary(config),
                                         None, None, device=device, mesh=mesh)
        trainer.generator = None
        return trainer.train_step(batch).item(), _grads(trainer)

    backend = "nccl" if device == "cuda" else "gloo"
    want_loss, want = step()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            mesh = make_mesh(config)
            (loss, grads), n = counted(device, f"DP step B=32, one {backend} rank",
                                       {"lstm_seq_train_fwd": L, "lstm_seq_train_bwd": L},
                                       lambda: step(mesh))
            out["launches"] = add_counts(out["launches"], n)
            out["one_rank"] = _compare_steps(f"DP step B=32 on a {mesh.shape} {backend} mesh vs "
                                             "no process group", loss, grads, want_loss, want)
        finally:
            dist.destroy_process_group()

    cards = torch.cuda.device_count() if device == "cuda" else 0
    if cards > 1:
        ranks = spawn_ranks(dp_step_rank, 2, (config.to_dict(), batch), backend="nccl",
                            timeout=300.0)
        for r in ranks:
            out["two_ranks"] = _compare_steps("DP step B=32 over 2 NCCL ranks (16 rows each) vs "
                                              "one process", r["loss"], r["grads"], want_loss,
                                              want)
    else:
        print(f"[parallel] DP step across 2 NCCL ranks: not run ({cards} card(s) visible)")

    with tempfile.TemporaryDirectory() as tmp:
        pkg = smoke_package(tmp, Config())
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            port = s_.getsockname()[1]
        proc = subprocess.Popen([sys.executable, "-m", "video_captioning_tpu_torch.cli.serve",
                                 "--model-path", pkg, "--data-parallel", "--port", str(port),
                                 "--device", device, "--max-batch", "8",
                                 "--log-level", "WARNING"],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                cwd=Path(__file__).resolve().parent)
        try:
            seen = []
            for line in proc.stdout:  # up to the server's ready line
                seen.append(line)
                if "listening" in line:
                    break
            else:
                raise AssertionError(f"cli.serve --data-parallel exited: {''.join(seen)[-3000:]}")
            feats = [np.round(c, 3) for c in clips[:4]]
            got = [_http(port, "/caption", {"features": f.tolist(), "method": "beam",
                                            "beam_size": 5}) for f in feats]
        finally:
            proc.terminate()
            proc.wait(timeout=60)
        ref = VideoCaptionPredictor(pkg, device=device).predict_batch(feats, method="beam",
                                                                      beam_size=5)
        for g, r in zip(got, ref):
            if g["tokens"] != r["tokens"]:
                raise AssertionError("cli.serve --data-parallel: tokens differ from no mesh")
        print(f"[parallel] cli.serve --data-parallel over {max(cards, 1)} device(s): "
              f"{len(got)} /caption requests answered, tokens equal to a predictor without a "
              "mesh")

    out["orbax"] = run_orbax_training(card, device)
    return out


def run_orbax_training(card: str, device: str = "cuda", n_clips: int = 64) -> dict:
    """``cli.train --checkpoint-backend orbax`` for 2 epochs at B = 32, the
    final state saved once more, then a fresh trainer resumed from that
    epoch's directory (its parameters and Adam moments equal to the trained
    ones), then ``cli.train --resume`` from it for one epoch more."""
    config = Config()
    config.data.vocab_threshold = 1
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            csv_path = training_data(Path(tmp), config, n_clips)
            cfg_path = Path(tmp) / "config.json"
            cfg_path.write_text(json.dumps(config.to_dict()))
            args = ["--config", str(cfg_path), "--data-file", str(csv_path),
                    "--checkpoint-dir", "ck", "--checkpoint-backend", "orbax",
                    "--device", device, "--log-level", "WARNING"]
            t0 = time.perf_counter()
            trainer = cli_train.main(args + ["--epochs", "2"])
            out["wall_s"] = time.perf_counter() - t0
            trainer._save(trainer.current_epoch, {}, is_best=False)  # the final state
            trainer.orbax_manager.wait()
            epochs = trainer.orbax_manager.all_epochs()
            fresh = VideoCaptioningTrainer(_model(trainer.config, device), trainer.config,
                                           trainer.vocabulary, None, None, device=device)
            fresh.load_orbax_checkpoint()
            for k, v in trainer.model.state_dict().items():
                if not torch.equal(fresh.model.state_dict()[k], v):
                    raise AssertionError(f"orbax resume: parameter {k} differs")
            want, got = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
            for i, entry in want["state"].items():
                for key, value in entry.items():
                    if not torch.equal(got["state"][i][key].cpu(), value.cpu()):
                        raise AssertionError(f"orbax resume: optimizer {i} {key} differs")
            resumed = cli_train.main(args + ["--resume", f"ck/orbax/{epochs[-1]}",
                                             "--epochs", str(epochs[-1] + 2)])
            sync(device)
            history = [h["loss"] for h in resumed.train_history]
            if not (history and np.isfinite(history).all()) or not Path(
                    "ck/model_for_inference.pth").exists():
                raise AssertionError(f"orbax resume run: losses {history}")
            print(f"[parallel] orbax backend (torch.distributed.checkpoint): cli.train 2 epochs "
                  f"at B={config.training.batch_size} in {out['wall_s']:.1f} s ({card}); epochs "
                  f"on disk {epochs}; a fresh trainer's resume has every parameter and Adam "
                  f"moment equal to the trained ones; cli.train --resume ran epochs "
                  f"{[h['epoch'] for h in resumed.train_history]} (losses {history})")
        finally:
            os.chdir(cwd)
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
    lstm_wide = check_lstm("cuda", smi, H=1024)
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
        "ms", "graph_ms", "sweep_device_ms", "dw_device_ms", "dw_library_ms", "bound_ms",
        "library_ms")}
    train_wide = check_lstm_train("cuda", smi, B=32, H=1024)
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
    int8 = run_int8_decode(smi, clips)
    bf16_train = run_bf16_training(smi)
    bf16_fused = run_bf16_fused(smi, clips)
    exported = run_export(smi, clips)
    bf16_transformer = run_bf16_transformer(smi, clips)
    bf16_exported = run_bf16_export(smi, clips)
    parallel = run_parallel(smi, clips)
    runs = (sl, fsl, tsl, tfsl, tr, ttr["train"], entry, wide, options, sampling, bf16, int8,
            bf16_train, bf16_fused, exported, bf16_transformer, bf16_exported, parallel)
    launches = {k: sum(run["launches"].get(k, 0) for run in runs)
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
        # The wide forms (600 < H <= 1024) of the three: other kernels of
        # the same sources, launched by the H = 1024 encoder's phase.
        ("lstm_seq_wide", "lstm_seq_wide", "video_captioning_tpu_torch/csrc/lstm_seq.cu",
         "video_captioning_tpu/ops/lstm_seq_pallas.py:49", lstm_wide),
        ("lstm_seq_train_fwd_wide", "lstm_seq_train_fwd_wide", train_src,
         "video_captioning_tpu/ops/lstm_seq_pallas.py:180", train_wide["fwd"]),
        ("lstm_seq_train_bwd_wide", "lstm_seq_train_bwd_wide", train_src,
         "video_captioning_tpu/ops/lstm_seq_pallas.py:244", train_wide["bwd"]),
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
