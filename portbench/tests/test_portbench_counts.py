"""The frozen operation and byte counts against hand reckonings, one shape
each."""

from __future__ import annotations

import json

import pytest

from portbench.counts import kernels, models

from conftest import REPO


def test_lstm_seq_at_the_main_shape():
    ops, nbytes = kernels.lstm_seq(80, 2, 128, 512)
    # 2 * T * ND * B * H * 4H products plus the gate arithmetic.
    assert ops == 2 * 80 * 2 * 128 * 512 * 2048 + 10 * 80 * 2 * 128 * 512
    # xproj 167,772,160 + bf16 W_hh 4,194,304 + outputs 41,943,040 + h, c 1,048,576
    assert nbytes == 167_772_160 + 4_194_304 + 41_943_040 + 1_048_576
    assert kernels.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)  # bytes bound


def test_topk2d_lse_reads_each_logit_once():
    ops, nbytes = kernels.topk2d_lse(640, 10000, 5)
    assert nbytes == 640 * 10000 * 4 + 640 * 5 * 8 + 640 * 4
    assert kernels.bound_s(ops, nbytes) == pytest.approx(25_628_160 / 3.35e12)


def test_beam_cross_attention_shares_a_clips_frames_over_its_beams():
    ops, nbytes = kernels.beam_cross_attention(128, 5, 80, 512, 8)
    assert ops == 4 * 128 * 5 * 80 * 512 + 5 * 128 * 5 * 8 * 80
    # q 1,310,720 + K and V 41,943,040 + mask 40,960, out 1,310,720 + 204,800 bytes
    assert nbytes == 1_310_720 + 41_943_040 + 40_960 + 1_310_720 + 204_800


def test_fused_bottleneck_stage_one():
    ops, nbytes = kernels.fused_bottleneck(32, 56, 56, 256, 64)
    M = 32 * 56 * 56
    assert ops == 2 * M * (256 * 64 + 9 * 64 * 64 + 64 * 256) + 4 * M * 256
    assert nbytes == 4 * (2 * M * 256 + 256 * 64 + 9 * 64 * 64 + 64 * 256 + 2 * 64 + 256)
    _, _, launches = kernels.resnet50_fused_forward(32)
    assert launches == 12  # 2 + 3 + 5 + 2 identity blocks


def test_resnet50_is_about_4_1_gmacs_a_frame():
    assert models.resnet50_flops_per_frame(224) == pytest.approx(2 * 4.09e9, rel=0.01)


def test_lstm_captioner_at_a_small_shape():
    m = {"cnn_feature_dim": 8, "encoder_hidden_dim": 4, "decoder_hidden_dim": 4,
         "embedding_dim": 4, "attention_dim": 4, "vocab_size": 10, "encoder_num_layers": 1,
         "decoder_num_layers": 1, "video_sequence_length": 3}
    B, K, L, S = 2, 3, 2, 3
    enc = (2 * B * S * 8 * 4                       # feature projection
           + 2 * (2 * B * S * 4 * 16 + 2 * B * S * 4 * 16)  # both directions' products
           + 2 * B * S * 8 * 4 + 2 * B * S * 4 * 4)  # output and attention projections
    N = B * K
    step = (2 * N * 4 * 4 + 3 * N * S * 4 + 2 * N * S * 4 + 2 * N * (8 + 4) * 16
            + 2 * N * 12 * 4 + 2 * N * 4 * 10)
    assert models.captioner_flops(m, B, K, L) == enc + L * step


def test_peaks_are_the_data_sheets():
    peaks = json.loads((REPO / "portbench/counts/peaks.json").read_text())
    assert peaks["flops_per_s"] == 989e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["int8_ops_per_s"] == 1979e12
