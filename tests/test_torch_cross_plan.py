"""``beam_cross_attention``'s launch plan and the order its kernel computes
in, on the CPU.

The kernel (csrc/transformer_attn.cu) gives each (clip, head) a CTA that
stages the head's keys and values (whole where they take at most 24 KB,
else in 32-frame chunks through two slots, all by 16-byte copies in flight
from entry), scores every frame, takes the softmax with each lane summing
its frames l, l + 32, ... in order and a butterfly over the lanes, and sums
the context frame by frame in order; a second launch averages the heads in
head order. ``cross_plan`` picks the staging; these tests hold every plan
the contract admits (dh <= 128, K <= 16, 1 to 16 heads, S up to 2000) to
the card's limits, and a plain model of the kernel's order to the JAX
Pallas kernel in interpret mode and to the port's plain version. The CUDA
kernel itself is held bit for bit to an earlier checkout's by
compare_attention.py and to the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_captioning_tpu.ops.transformer_attn_pallas import beam_cross_attention as j_beam_cross
from video_captioning_tpu_torch.ops.transformer_attn import (
    CROSS_RESIDENT_SMEM,
    CROSS_RING_FRAMES,
    CROSS_SMEM,
    MASK_FILL,
    beam_cross_attention,
    beam_cross_attention_reference,
    cross_plan,
    cross_smem,
)

SM_SHARED = 233472   # an H100 SM's shared memory (228 KB)
CTA_RESERVED = 1024  # shared memory the card keeps for each resident CTA
SM_THREADS = 2048

HEAD_WIDTHS = (1, 4, 8, 15, 16, 24, 32, 64, 96, 128)
BEAMS = (1, 2, 5, 16)
FRAMES = (1, 9, 31, 32, 33, 41, 80, 300, 2000)


def _chunks(plan, S):
    """The frames of each key (and value) chunk of a plan."""
    FC = plan["FC"]
    return [(c * FC, min(S, (c + 1) * FC)) for c in range(plan["nch"])]


@pytest.mark.parametrize("kv_bytes", [4, 2])
@pytest.mark.parametrize("H", list(range(1, 17)))
def test_cross_plan_fits_and_covers_every_frame_and_head(H, kv_bytes):
    """Every plan fits a CTA's shared memory; a clip has one CTA a head,
    all its frames in that CTA (never split), its chunks
    covering every frame once and each starting where lane 0 owns the
    frame; a slice is resident (one chunk of keys, one of values) when it
    is one ring chunk or takes at most CROSS_RESIDENT_SMEM, else it streams
    through two slots of CROSS_RING_FRAMES frames."""
    for dh in HEAD_WIDTHS:
        D = dh * H
        for K in BEAMS:
            for S in FRAMES:
                for vec in (True, False):
                    if vec and (dh * kv_bytes) % 16:
                        continue
                    plan = cross_plan(K, H, D, S, kv_bytes, vec)
                    where = (K, H, D, S, kv_bytes, vec, plan)
                    assert plan["smem"] <= CROSS_SMEM, where
                    assert plan["smem"] == cross_smem(K, H, D, S, kv_bytes, vec, plan["FC"]), where
                    chunks = _chunks(plan, S)
                    assert [f for c0, c1 in chunks for f in range(c0, c1)] == list(range(S)), where
                    assert all(c0 % 32 == 0 for c0, _ in chunks), where
                    whole = cross_smem(K, H, D, S, kv_bytes, vec, S)
                    if S <= CROSS_RING_FRAMES or whole <= CROSS_RESIDENT_SMEM:
                        assert plan["nch"] == 1 and plan["FC"] == S, where
                    else:
                        assert plan["FC"] == CROSS_RING_FRAMES, where
                        assert plan["smem"] < whole, where


@pytest.mark.parametrize("kv_bytes", [4, 2])
def test_cross_plan_main_shape_runs_in_one_wave(kv_bytes):
    """The fused beam step's shape (B = 128, K = 5, 8 heads, D = 512,
    S = 80): 1024 CTAs of 160 threads; float32 streams 32-frame chunks so
    that eleven fit an SM, bfloat16 stages the slice whole (nine an SM);
    either way the grid fits the H100's 132 SMs at once."""
    plan = cross_plan(5, 8, 512, 80, kv_bytes, True)
    assert (plan["nch"] == 1) == (kv_bytes == 2)
    per_sm = min(SM_SHARED // (plan["smem"] + CTA_RESERVED), SM_THREADS // (32 * 5))
    assert per_sm >= (11 if kv_bytes == 4 else 9)
    assert 132 * per_sm >= 128 * 8


def cross_model(q, ck, cv, mask, H, K):
    """beam_cross_attention in the kernel's order, float32: for each (clip,
    head) and beam, each frame's score (the products summed over the head's
    columns in order, then the scale, then the mask fill); the max; each of
    32 lanes summing exp(score - max) over its frames l, l + 32, ... in
    order, then the butterfly over lane offsets 16, 8, 4, 2, 1; the weights
    e / sum; the context summed frame by frame in order; then each (beam,
    frame) weight the heads added in head order from 0, over H."""
    N, D = q.shape
    B, S, _ = ck.shape
    dh = D // H
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(torch.tensor(float(dh)))
    ctx = torch.empty(B, K, H, dh)
    per_head = torch.empty(H, B, K, S)
    rounds = -(-S // 32)
    lanes = torch.arange(32)
    for b in range(B):
        for h in range(H):
            qb = q.float()[b * K:(b + 1) * K, h * dh:(h + 1) * dh]
            kb = ck.float()[b, :, h * dh:(h + 1) * dh]
            vb = cv.float()[b, :, h * dh:(h + 1) * dh]
            sc = torch.zeros(K, S)
            for d in range(dh):
                sc = sc + qb[:, d:d + 1] * kb[:, d][None, :]
            sc = sc * scale
            if mask is not None:
                sc = torch.where(mask[b] > 0, sc, torch.full_like(sc, MASK_FILL))
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            padded = torch.zeros(K, rounds * 32)
            padded[:, :S] = e
            part = torch.zeros(K, 32)
            for r in range(rounds):
                part = part + padded[:, r * 32:(r + 1) * 32]
            for off in (16, 8, 4, 2, 1):
                part = part + part[:, lanes ^ off]
            w = e / part[:, :1]
            per_head[h, b] = w
            acc = torch.zeros(K, dh)
            for s in range(S):
                acc = acc + w[:, s:s + 1] * vb[s][None, :]
            ctx[b, :, h] = acc
    mean = torch.zeros(B, K, S)
    for h in range(H):
        mean = mean + per_head[h]
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
            mask[1] = (np.arange(S) < max(1, S // 3)).astype(np.float32)
    return q, ck, cv, mask


# (B, K, S, D, heads, K/V dtype): S = 1; S = 41 (two lane rounds and a
# ragged third); S = 70 (a 32-frame ring's chunks); 8 and 12 heads;
# bfloat16 keys and values.
CASES = [(3, 2, 1, 16, 4, "float32"), (2, 5, 41, 32, 8, "float32"),
         (2, 2, 70, 16, 4, "float32"), (2, 3, 11, 24, 12, "float32"),
         (2, 2, 41, 32, 8, "bfloat16")]


@pytest.mark.parametrize("mask_kind", ["ragged", "none"])
@pytest.mark.parametrize("B,K,S,D,H,dtype", CASES)
def test_cross_order_matches_pallas(B, K, S, D, H, dtype, mask_kind):
    q, ck, cv, mask = _cross_inputs(B, K, S, D, seed=3 * S + H, mask_kind=mask_kind)
    jk, jv = (jnp.asarray(c).astype(dtype) for c in (ck, cv))
    want_ctx, want_w = j_beam_cross(jnp.asarray(q), jk, jv,
                                    None if mask is None else jnp.asarray(mask), H, K,
                                    interpret=True)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(q), torch.from_numpy(ck).to(tdt), torch.from_numpy(cv).to(tdt),
            None if mask is None else torch.from_numpy(mask))
    got_ctx, got_w = cross_model(*args, H, K)
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
