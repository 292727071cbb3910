"""The port's kernel modules on the CPU: each plain version against the JAX
Pallas kernel it stands for (run in interpret mode), the CPU dispatch of
the wrappers, and the build's refusal to fall back where nvcc is absent.
The CUDA kernels themselves are checked against these plain versions on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_captioning_tpu.ops.lstm_seq_pallas import lstm_seq_pallas
from video_captioning_tpu.ops.topk_pallas import topk2d_lse_pallas
from video_captioning_tpu_torch.ops import build, launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.attention import bahdanau_attend, bahdanau_attend_reference
from video_captioning_tpu_torch.ops.bottleneck import fused_bottleneck, fused_bottleneck_reference
from video_captioning_tpu_torch.ops.conv1x1 import matmul_bias_act, matmul_bias_act_reference
from video_captioning_tpu_torch.ops.int8_matmul import (
    int8_matmul_requant,
    int8_matmul_requant_reference,
    int8_matmul_residual_requant,
    int8_matmul_residual_requant_reference,
)
from video_captioning_tpu_torch.ops.lstm_cell import lstm_cell_fused, lstm_cell_reference
from video_captioning_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_reference
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
)
from video_captioning_tpu_torch.ops.vocab_topk import (
    pad_vocab_weights,
    vocab_topk_lse,
    vocab_topk_lse_reference,
)


def _lstm_inputs(T=7, B=5, H=16, seed=0, ragged=True, short_row=False):
    rs = np.random.RandomState(seed)
    xproj = (rs.randn(T, 2, B, 4 * H) * 0.8).astype(np.float32)
    w_hh = (rs.uniform(-1, 1, (2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    if not ragged:
        return xproj, w_hh, None
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T  # one full row
    if short_row:
        lengths[-1] = 1  # a length-1 row (the only row at B = 1)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return xproj, w_hh, mask


# (B, T, H, a length-1 row): the main cases, then the edges the card's
# tiling must take (B = 1, T = 1, H = 40, which is not a multiple of 16).
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("B,T,H,short_row", [
    (5, 7, 16, False), (8, 7, 16, False), (1, 7, 16, True), (5, 1, 16, True), (5, 7, 40, True),
], ids=["5", "8", "B1", "T1", "H40"])
def test_lstm_seq_reference_matches_pallas_f32(B, T, H, short_row, ragged):
    xproj, w_hh, mask = _lstm_inputs(T=T, B=B, H=H, ragged=ragged, seed=B, short_row=short_row)
    want_o, (want_h, want_c) = lstm_seq_pallas(
        jnp.asarray(xproj), jnp.asarray(w_hh),
        None if mask is None else jnp.asarray(mask), interpret=True)
    got_o, (got_h, got_c) = lstm_seq_reference(
        torch.from_numpy(xproj), torch.from_numpy(w_hh).to(torch.bfloat16),
        None if mask is None else torch.from_numpy(mask))
    # Same bf16 operands and float32 gate math; only the float32 sum order
    # of the recurrent product differs.
    for got, want in ((got_o, want_o), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if mask is not None:  # padded steps emit exactly zero
        assert np.all(got_o.numpy().transpose(0, 2, 1, 3)[mask.T == 0] == 0)


def test_lstm_seq_reference_matches_pallas_bf16():
    xproj, w_hh, mask = _lstm_inputs(B=6, seed=3)
    x16 = jnp.asarray(xproj).astype(jnp.bfloat16)
    want_o, (want_h, want_c) = lstm_seq_pallas(
        x16, jnp.asarray(w_hh), jnp.asarray(mask), interpret=True)
    got_o, (got_h, got_c) = lstm_seq_reference(
        torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(w_hh).to(torch.bfloat16), torch.from_numpy(mask))
    assert got_o.dtype == torch.bfloat16
    # Outputs are rounded to bf16 (8 bits of mantissa): one bf16 ulp at |x| < 1.
    for got, want in ((got_o, want_o), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=2 ** -8)


def _topk_inputs(N=64, V=300, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(N, V) * 3).astype(np.float32)
    x[5, [7, V // 3, V - 1]] = 9.5     # tie at the top
    x[6, :] = 1.25                      # whole row tied
    x[7, 40:60] = x[7].max()            # run of ties
    x[8, V // 2:] = -np.inf             # -inf tail
    return x


def _check_topk2d_lse_against_pallas(x, k):
    xp = np.pad(x, ((0, 0), (0, -x.shape[1] % 128)), constant_values=-np.inf)
    want_v, want_i, want_lse = topk2d_lse_pallas(jnp.asarray(xp), k, interpret=True)
    got_v, got_i, got_lse = topk2d_lse_reference(torch.from_numpy(x), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk2d_lse_reference_matches_pallas(k):
    _check_topk2d_lse_against_pallas(_topk_inputs(seed=k), k)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk2d_lse_reference_matches_pallas_at_the_kernels_odd_shape(k):
    """A row of V % 4 != 0 (the kernel's scalar-load build) and a ragged
    row count."""
    _check_topk2d_lse_against_pallas(_topk_inputs(37, 10001, seed=k), k)


def test_topk2d_lse_reference_all_neg_inf_row():
    x = torch.full((3, 40), float("-inf"))
    x[1, 3] = 0.0
    vals, idx, lse = topk2d_lse_reference(x, 4)
    assert torch.isneginf(lse[0]) and torch.isneginf(lse[2])
    assert lse[1].item() == 0.0
    assert idx[0].tolist() == [0, 1, 2, 3]  # lax.top_k order among equal -inf
    assert idx[1].tolist() == [3, 0, 1, 2]


def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    reset_launch_counts()
    x = torch.from_numpy(_topk_inputs())
    got = topk2d_lse(x, 5)
    want = topk2d_lse_reference(x, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    xproj, w_hh, mask = (torch.from_numpy(a) for a in _lstm_inputs())
    w16 = w_hh.to(torch.bfloat16)
    got_o, (got_h, _) = lstm_seq(xproj, w16, mask)
    want_o, (want_h, _) = lstm_seq_reference(xproj, w16, mask)
    assert torch.equal(got_o, want_o) and torch.equal(got_h, want_h)
    for g, w in zip(topk2d(x, 5), topk2d_reference(x, 5)):
        assert torch.equal(g, w)
    g = torch.Generator().manual_seed(0)
    layer = {n: torch.randn(s, generator=g) for n, s in (
        ("w_ih", (64, 12)), ("w_hh", (64, 16)), ("b_ih", (64,)), ("b_hh", (64,)))}
    xs, h, c = (torch.randn((3, n), generator=g) for n in (12, 16, 16))
    for a, b in zip(lstm_cell_fused(layer, xs, h, c), lstm_cell_reference(layer, xs, h, c)):
        assert torch.equal(a, b)
    attn_args = (torch.randn((2, 16), generator=g), torch.randn((8, 16), generator=g),
                 torch.randn((8,), generator=g), torch.randn((2, 5, 8), generator=g),
                 torch.randn((2, 5, 6), generator=g), torch.randn((8,), generator=g),
                 torch.randn((1,), generator=g), torch.ones((2, 5)))
    for a, b in zip(bahdanau_attend(*attn_args), bahdanau_attend_reference(*attn_args)):
        assert torch.equal(a, b)
    w_pad, b_pad, _ = pad_vocab_weights(torch.randn((16, 30), generator=g),
                                        torch.randn((30,), generator=g))
    for a, b in zip(vocab_topk_lse(h, w_pad, b_pad, 4),
                    vocab_topk_lse_reference(h, w_pad, b_pad, 4)):
        assert torch.equal(a, b)
    q, caches = torch.randn((6, 16), generator=g), torch.randn((2, 4, 6, 16), generator=g)
    anc = torch.zeros((3, 2, 4), dtype=torch.int32)
    assert torch.equal(beam_self_attention(q, caches[0], caches[1], anc, 2, 4, 2),
                       beam_self_attention_reference(q, caches[0], caches[1], anc, 2, 4, 2))
    ck, cv = caches[0, :3, :5], caches[1, :3, :5]
    ck, cv = ck.contiguous(), cv.contiguous()
    for a, b in zip(beam_cross_attention(q, ck, cv, None, 4, 2),
                    beam_cross_attention_reference(q, ck, cv, None, 4, 2)):
        assert torch.equal(a, b)
    xb = torch.randn((1, 3, 4, 8), generator=g)
    bw = [torch.randn(s, generator=g) for s in ((2, 8), (2,), (2, 2, 3, 3), (2,), (8, 2), (8,))]
    bw[2] = bw[2].contiguous(memory_format=torch.channels_last)
    assert torch.equal(fused_bottleneck(xb, *bw), fused_bottleneck_reference(xb, *bw))
    wl, bl = layer["w_ih"], layer["b_ih"]
    assert torch.equal(matmul_bias_act(xs, wl, bl), matmul_bias_act_reference(xs, wl, bl))
    xq, wq = (torch.randint(-127, 128, s, generator=g, dtype=torch.int8) for s in ((5, 12), (4, 12)))
    sc, bi = torch.rand((4,), generator=g), torch.randn((4,), generator=g)
    assert torch.equal(int8_matmul_requant(xq, wq, sc, bi, 3.0),
                       int8_matmul_requant_reference(xq, wq, sc, bi, 3.0))
    idq = xq[:, :4].contiguous()
    assert torch.equal(int8_matmul_residual_requant(xq, wq, sc, bi, idq, 0.5),
                       int8_matmul_residual_requant_reference(xq, wq, sc, bi, idq, 0.5))
    assert launch_counts() == {"lstm_seq": 0, "topk2d_lse": 0, "lstm_seq_train_fwd": 0,
                               "lstm_seq_train_bwd": 0, "topk2d": 0, "bahdanau_attend": 0,
                               "lstm_cell_fused": 0, "vocab_topk_lse": 0,
                               "beam_self_attention": 0, "beam_cross_attention": 0,
                               "fused_bottleneck": 0, "matmul_bias_act": 0,
                               "int8_matmul_requant": 0, "int8_matmul_residual_requant": 0,
                               "lstm_seq_wide": 0, "lstm_seq_train_fwd_wide": 0,
                               "lstm_seq_train_bwd_wide": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 20)
    with pytest.raises(ValueError):
        topk2d_lse(x, 17)
    with pytest.raises(ValueError):
        topk2d_lse(x.double(), 3)
    with pytest.raises(ValueError):
        topk2d_lse(x.T, 3)  # not contiguous
    # Neither CPU nor CUDA: no plain-version fallback.
    with pytest.raises(ValueError):
        topk2d_lse(torch.empty(4, 20, device="meta"), 3)
    xproj = torch.zeros(3, 2, 4, 32)
    with pytest.raises(ValueError):
        lstm_seq(xproj, torch.zeros(2, 8, 32), None)  # W_hh not bf16
    with pytest.raises(ValueError):
        lstm_seq(xproj, torch.zeros(2, 8, 32, dtype=torch.bfloat16), torch.ones(4, 2))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("topk_lse")
    assert not (tmp_path / "build").exists()


def test_build_variant_passes_its_defines_and_gets_its_own_library(monkeypatch, tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho \"$@\"\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="-DVCT_INT8_DIVIDE_ALL=1"):
        build.load_library("int8_matmul", ("VCT_INT8_DIVIDE_ALL=1",))
    plain = build._library_path("int8_matmul", build.NVCC_FLAGS)
    variant = build._library_path("int8_matmul", (*build.NVCC_FLAGS, "-DVCT_INT8_DIVIDE_ALL=1"))
    assert plain != variant
    assert plain == build._library_path("int8_matmul", build.NVCC_FLAGS)
