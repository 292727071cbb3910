"""The two encoder-attention kernels' decompositions on the CPU.

``bahdanau_attend``'s row kernel splits each row's frames over a cluster of
CTAs (``ops/attention.py:attend_plan``), streams each slice in chunks with
a running max and sum and an unnormalised partial context, and combines
the cluster's partials in rank order. ``beam_cross_attention``'s kernel
takes each head's softmax over the clip's frames (scored in chunks of 32)
in a CTA of its own and averages the heads in head order in a second
launch. Each decomposition is modelled here in plain PyTorch (with the
plan the row kernel is given) and held against the JAX Pallas kernel in
interpret mode, and the port's plain version, at the tolerances of
tests/test_torch_decode_kernels.py and tests/test_torch_transformer_kernels.py.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_captioning_tpu.ops.attention_pallas import bahdanau_attend_pallas
from video_captioning_tpu.ops.transformer_attn_pallas import beam_cross_attention as j_beam_cross
from video_captioning_tpu_torch.ops.attention import (
    SMEM_LIMIT as ATTEND_SMEM_LIMIT,
    attend_plan,
    bahdanau_attend,
    bahdanau_attend_reference,
)
from video_captioning_tpu_torch.ops.transformer_attn import (
    MASK_FILL,
    beam_cross_attention,
    beam_cross_attention_reference,
)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, order="C"))


def _slices(S, parts):
    return [(r * S // parts, (r + 1) * S // parts) for r in range(parts)]


def _chunks(s0, s1, F):
    return [(c, min(c + F, s1)) for c in range(s0, s1, F)]


# --------------------------------------------------------------- bahdanau


def split_attend(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask):
    """bahdanau_attend as the row kernel computes it: each row's frames over
    the plan's CS slices, each slice in chunks of FC frames with a running
    max m, sum l and partial context sum exp(s - m) enc_outs; the row's max
    and sum and its context from the slices' partials in rank order."""
    B, S, A = enc_proj.shape
    E = enc_outs.shape[-1]
    plan = attend_plan(S, A, E, True)
    dp = h @ w_d.T + b_d
    context, weights = torch.empty(B, E), torch.empty(B, S)
    for b in range(B):
        raw = torch.empty(S)
        parts = []
        for s0, s1 in _slices(S, plan["CS"]):
            m, l, cx = torch.tensor(-math.inf), torch.tensor(0.0), torch.zeros(E)
            for c0, c1 in _chunks(s0, s1, plan["FC"]):
                sc = torch.tanh(enc_proj[b, c0:c1] + dp[b]) @ v + b_v
                if mask is not None:
                    sc = torch.where(mask[b, c0:c1] > 0, sc, torch.full_like(sc, MASK_FILL))
                raw[c0:c1] = sc
                m_new = torch.maximum(m, sc.max())
                e = torch.exp(sc - m_new)
                rs = torch.exp(m - m_new)
                l, cx, m = l * rs + e.sum(), cx * rs + e @ enc_outs[b, c0:c1], m_new
            parts.append((m, l, cx))
        m_row = parts[0][0]
        for m, _, _ in parts[1:]:
            m_row = torch.maximum(m_row, m)
        l_row, ctx = torch.tensor(0.0), torch.zeros(E)
        for m, l, cx in parts:  # rank order
            fac = torch.exp(m - m_row)
            l_row, ctx = l_row + l * fac, ctx + cx * fac
        context[b] = ctx / l_row
        weights[b] = torch.exp(raw - m_row) / l_row
    return context, weights


def _attend_inputs(B, S, D, A, E, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, D).astype(np.float32)
    w_d = (rs.randn(D, A) * 0.3).astype(np.float32)  # JAX layout (D, A)
    b_d = (rs.randn(A) * 0.1).astype(np.float32)
    enc_outs = rs.randn(B, S, E).astype(np.float32)
    enc_proj = (rs.randn(B, S, A) * 0.5).astype(np.float32)
    v = (rs.randn(A) * 0.3).astype(np.float32)
    b_v = np.float32(0.05)
    return h, w_d, b_d, enc_proj, enc_outs, v, b_v


def _attend_mask(B, S, kind, seed):
    if kind == "none":
        return None
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, S + 1, size=B)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    mask[0] = 0.0                          # a fully masked row
    if B > 1:
        mask[1] = (np.arange(S) < max(1, S // 3)).astype(np.float32)  # later slices all masked
    return mask


# S = 1; S = 13 (not a multiple of the split); S = 70 (slices longer than a
# chunk: the ring); A != E; A % 4 != 0.
ATTEND_CASES = [(3, 1, 16, 24, 20), (5, 13, 16, 24, 20), (3, 70, 16, 24, 20),
                (2, 9, 12, 30, 10)]


@pytest.mark.parametrize("mask_kind", ["ragged", "none"])
@pytest.mark.parametrize("B,S,D,A,E", ATTEND_CASES)
def test_split_attend_matches_pallas(B, S, D, A, E, mask_kind):
    h, w_d, b_d, enc_proj, enc_outs, v, b_v = _attend_inputs(B, S, D, A, E, seed=S)
    mask = _attend_mask(B, S, mask_kind, seed=100 + S)
    want_ctx, want_w = bahdanau_attend_pallas(
        jnp.asarray(h), jnp.asarray(w_d), jnp.asarray(b_d), jnp.asarray(enc_proj),
        jnp.asarray(enc_outs), jnp.asarray(v), jnp.asarray(b_v),
        None if mask is None else jnp.asarray(mask), interpret=True)
    args = (t(h), t(w_d.T), t(b_d), t(enc_proj), t(enc_outs), t(v), t(np.array([b_v])), t(mask))
    got_ctx, got_w = split_attend(*args)
    # The JAX kernel test's own tolerance (test_pallas_kernels.py:45).
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-5)
    if mask is not None:
        np.testing.assert_allclose(got_w[0].numpy(), np.full(S, 1.0 / S), rtol=0, atol=1e-7)
    plain = bahdanau_attend_reference(*args)
    for a, b in zip((got_ctx, got_w), plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(bahdanau_attend(*args), plain))


@pytest.mark.parametrize("S,A,E", [(1, 512, 512), (80, 512, 512), (13, 24, 20), (2000, 512, 512),
                                   (41, 30, 50), (300, 2048, 2048)])
def test_attend_plan_covers_every_frame_within_shared_memory(S, A, E):
    """The slices and chunks of a plan cover each frame once; the ring
    holds two slots or more; the main shape's CTAs fit two an SM."""
    for bulk in (True, False):
        plan = attend_plan(S, A, E, bulk)
        assert 1 <= plan["CS"] <= 2 and plan["CS"] <= S and 1 <= plan["FC"] <= 32
        covered = [f for s0, s1 in _slices(S, plan["CS"]) for c0, c1 in _chunks(s0, s1, plan["FC"])
                   for f in range(c0, c1)]
        assert covered == list(range(S))
        assert plan["nst"] >= 2 and plan["smem"] <= ATTEND_SMEM_LIMIT
        assert not plan["resident"] or bulk
    if (S, A, E) == (80, 512, 512):
        assert attend_plan(S, A, E, True)["smem"] <= 113 * 1024


# ---------------------------------------------------------- beam cross


CROSS_CHUNK = 32  # frames a cross-attention CTA stages at a time (kChunk)


def split_cross(q, ck, cv, mask, H, K):
    """beam_cross_attention as its two launches compute it: for each
    (clip, head), every beam's scores chunk by chunk of 32 frames, the max
    over the clip, exp(s - max), its sum, the weights e / sum and the
    context sum of weights x values; then each frame's weight the mean over
    the heads, summed in head order."""
    N, D = q.shape
    B, S, _ = ck.shape
    dh = D // H
    scale = 1.0 / math.sqrt(dh)
    ctx, per_head = torch.empty(B, K, H, dh), torch.empty(B, K, H, S)
    for b in range(B):
        for h in range(H):
            qb = q.float()[b * K:(b + 1) * K, h * dh:(h + 1) * dh]        # (K, dh)
            kb = ck.float()[b, :, h * dh:(h + 1) * dh]                    # (S, dh)
            vb = cv.float()[b, :, h * dh:(h + 1) * dh]
            sc = torch.empty(K, S)
            for c0, c1 in _chunks(0, S, CROSS_CHUNK):
                sc[:, c0:c1] = qb @ kb[c0:c1].T * scale
            if mask is not None:
                sc = torch.where(mask[b] > 0, sc, torch.full_like(sc, MASK_FILL))
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            wts = e / e.sum(-1, keepdim=True)
            per_head[b, :, h] = wts
            ctx[b, :, h] = wts @ vb
    mean = per_head[:, :, 0]
    for h in range(1, H):  # head order
        mean = mean + per_head[:, :, h]
    return ctx.reshape(N, D), (mean / H).reshape(N, S)


def _cross_inputs(B, K, S, D, seed, mask_kind):
    rs = np.random.RandomState(seed)
    q = rs.randn(B * K, D).astype(np.float32)
    ck, cv = (rs.randn(B, S, D).astype(np.float32) for _ in range(2))
    mask = None
    if mask_kind != "none":
        lengths = rs.randint(1, S + 1, size=B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
        mask[0] = 0.0                                                   # a fully masked row
        if B > 1:
            mask[1] = (np.arange(S) < max(1, S // 3)).astype(np.float32)  # a slice all masked
    return q, ck, cv, mask


# (B, K, S, D, heads, K/V dtype): S = 1; S = 13; S = 70 (longer than a
# chunk); 12 and 16 heads (more than eight); bfloat16 keys and values.
CROSS_CASES = [(3, 2, 1, 16, 4, "float32"), (3, 5, 13, 16, 4, "float32"),
               (2, 2, 70, 16, 4, "float32"), (2, 3, 11, 24, 12, "float32"),
               (2, 2, 9, 32, 16, "float32"), (3, 2, 13, 16, 4, "bfloat16"),
               (2, 2, 70, 16, 4, "bfloat16")]


@pytest.mark.parametrize("mask_kind", ["ragged", "none"])
@pytest.mark.parametrize("B,K,S,D,H,dtype", CROSS_CASES)
def test_split_cross_matches_pallas(B, K, S, D, H, dtype, mask_kind):
    q, ck, cv, mask = _cross_inputs(B, K, S, D, seed=S + H, mask_kind=mask_kind)
    jk, jv = (jnp.asarray(c).astype(dtype) for c in (ck, cv))
    want_ctx, want_w = j_beam_cross(jnp.asarray(q), jk, jv,
                                    None if mask is None else jnp.asarray(mask), H, K,
                                    interpret=True)
    tdt = getattr(torch, dtype)
    args = (t(q), t(ck).to(tdt), t(cv).to(tdt), t(mask))
    got_ctx, got_w = split_cross(*args, H, K)
    # tests/test_torch_transformer_kernels.py's tolerance: float32 sums in
    # other orders over at most S terms; bfloat16 widened exactly.
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-5)
    if mask is not None:
        np.testing.assert_allclose(got_w[:K].numpy(), 1.0 / S, rtol=0, atol=1e-7)
    plain = beam_cross_attention_reference(*args, H, K)
    for a, b in zip((got_ctx, got_w), plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(beam_cross_attention(*args, H, K), plain))
