"""``beam_self_attention``'s launch plan and the way its kernel moves data,
on the CPU.

The kernel (csrc/transformer_attn.cu) gives each beam and four heads a
CTA of one warp, 8 lanes a head. The warp reads its beam's ancestry a
window of 32 positions at a time (the next window's ahead) and streams its
beam's rows (the four heads' key and value slices) through a ring of
stages of four positions in shared memory, ``stages - 1`` stages in flight
while it reads one; each head's eight lanes run the online softmax over
the positions in order, lane g holding what lanes g, g + 8, g + 16 and
g + 24 of a warp a head held.
``self_plan`` picks the stages and the shared memory; these tests hold
every plan of the kernel's domain (K <= 16, dh <= 128, any t) to the
card's limits, stage every position once, and run a plain model of the
kernel's staging and order against the JAX Pallas kernel in interpret mode
and the port's plain version: a ring row the model failed to fill reads
NaN. The CUDA kernel itself is held bit for bit to an earlier checkout's
by compare_attention.py and to the plain version on the card by
chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_captioning_tpu.ops.transformer_attn_pallas import beam_self_attention as j_beam_self
from video_captioning_tpu_torch.ops.transformer_attn import (
    CROSS_SMEM,
    SELF_BUDGET,
    SELF_HEADS,
    SELF_MAX_STAGES,
    SELF_PAD,
    SELF_STAGE,
    beam_self_attention,
    beam_self_attention_reference,
    self_plan,
)

SM_SHARED = 233472   # an H100 SM's shared memory (228 KB)
CTA_RESERVED = 1024  # shared memory the card keeps for each resident CTA
SMS = 132

HEAD_WIDTHS = (1, 8, 16, 25, 32, 48, 64, 96, 128)
POSITIONS = (0, 1, 2, 3, 4, 7, 8, 10, 13, 15, 16, 19, 20, 31, 32, 33, 63, 64, 69, 100, 999)


WINDOW = 32  # positions of the ancestry a warp holds in a register


def ring_schedule(t: int, S: int) -> tuple:
    """The kernel's loop over stages -S .. nst - 1 with a ring of S slots:
    stage s >= 0 read from the next slot in turn, then stage s + S copied
    into the next slot to fill. Returns the positions in the order copied,
    those in the order read, and for each copy its positions' ancestry
    windows beside the window being read (0 before any read)."""
    nst = t // SELF_STAGE + 1
    slots = [None] * S
    fill = read = 0
    copied, taken, windows = [], [], []
    for s in range(-S, nst):
        if s >= 0:
            taken += slots[read]
            slots[read] = None
            read = (read + 1) % S
        s1 = s + S
        stage = [u for u in range(SELF_STAGE * s1, SELF_STAGE * (s1 + 1)) if u <= t]
        assert slots[fill] is None or not stage, "a stage copied over one not yet read"
        slots[fill] = stage
        fill = (fill + 1) % S
        copied += stage
        windows += [(u // WINDOW, max(s, 0) * SELF_STAGE // WINDOW) for u in stage]
    return copied, taken, windows


@pytest.mark.parametrize("cache_bytes", [4, 2])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 8, 16])
def test_self_plan_fits_and_stages_every_position_once(K, cache_bytes):
    """Every plan fits a CTA's shared memory; its ring, run as the kernel
    fills and reads it, copies every position 0..t once and in order,
    never over a stage not yet read, reads each once and in order, and
    copies no position outside the ancestry window being read or the next;
    a ring never holds more stages than the prefix has, holds two at least
    where the prefix has two, at most SELF_MAX_STAGES, and a third only
    within SELF_BUDGET."""
    for dh in HEAD_WIDTHS:
        for t in POSITIONS:
            plan = self_plan(K, dh, t, cache_bytes)
            where = (K, dh, t, cache_bytes, plan)
            S = plan["stages"]
            nst = -(-(t + 1) // SELF_STAGE)
            stage = SELF_STAGE * 2 * SELF_HEADS * (dh + SELF_PAD) * cache_bytes
            assert plan["smem"] == S * stage <= CROSS_SMEM, where
            assert 1 <= S <= min(nst, SELF_MAX_STAGES), where
            assert S >= min(2, nst), where
            assert S <= 2 or S * stage <= SELF_BUDGET, where
            assert SELF_STAGE * S <= WINDOW, where
            copied, taken, windows = ring_schedule(t, S)
            assert copied == taken == list(range(t + 1)), where
            assert all(cw <= w <= cw + 1 for w, cw in windows), where
            assert WINDOW % SELF_STAGE == 0


@pytest.mark.parametrize("cache_bytes", [4, 2])
def test_self_plan_main_shape_runs_in_one_wave(cache_bytes):
    """The fused beam step's shape (B = 128, K = 5, 8 heads, dh = 64,
    t = 19): 640 x 2 CTAs of one warp; two stages of four positions in
    float32 (18 KB a CTA), three in bfloat16 (13.5 KB), so twelve or more
    fit an SM (the H100 keeps at most 32 CTAs an SM), where the grid needs
    ten for one wave of its 132 SMs."""
    plan = self_plan(5, 64, 19, cache_bytes)
    assert plan == (dict(stages=2, smem=18432) if cache_bytes == 4
                    else dict(stages=3, smem=13824))
    per_sm = min(SM_SHARED // (plan["smem"] + CTA_RESERVED), 32)
    assert per_sm >= 12 and SMS * per_sm >= 640 * 2


@pytest.mark.parametrize("K,dh,t,cache_bytes", [
    (0, 64, 19, 4), (17, 64, 19, 4), (5, 0, 19, 4), (5, 129, 19, 2), (5, 64, -1, 4),
    (5, 64, 19, 1), (5, 64, 19, 8),
])
def test_self_plan_refused_outside_the_domain(K, dh, t, cache_bytes):
    with pytest.raises(ValueError, match="outside the kernel's domain"):
        self_plan(K, dh, t, cache_bytes)


def self_model(q, kc, vc, anc, t, H, K):
    """beam_self_attention as the kernel moves and sums its data, float32:
    for each beam and each four heads, the ancestry in two window
    registers (the window being read and the next, shifted as the reading
    enters a new window), each stage's rows (the heads' slices, padded)
    copied into its ring slot (every element NaN until copied) in the
    kernel's order of fills and reads; each head's score of a position from
    eight lanes: lane g's partial sums for columns g + 8 r + 32 i (over i in
    order, for r = 0..3), added as (P0 + P2) + (P1 + P3), then the
    butterfly over lane offsets 4, 2, 1, then the scale; the online softmax
    in order. It keeps the kernel's order of sums, but rounds each product
    and each sum where the kernel's fmaf rounds them once, so it holds the
    kernel's order and staging, not its bits (compare_attention.py holds
    those on the card)."""
    N, D = q.shape
    dh = D // H
    S = self_plan(K, dh, t, kc.element_size())["stages"]
    nst = t // SELF_STAGE + 1
    ldh = dh + SELF_PAD
    epl = -(-dh // 32)
    scale = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(dh)))
    lanes = torch.arange(8)
    cols = torch.tensor([[[g + 8 * r + 32 * i for i in range(epl)] for r in range(4)]
                         for g in range(8)])  # (lane, r, i)
    valid = cols < dh
    ctx = torch.empty(N, D)
    for n in range(N):
        b = n // K
        for y in range(-(-H // SELF_HEADS)):
            heads = [h for h in range(SELF_HEADS * y, SELF_HEADS * (y + 1)) if h < H]
            ring = torch.full((S, SELF_STAGE, 2, SELF_HEADS, ldh), float("nan"))
            own = anc[b, n % K]
            window = {"cw": 0, "aw": own[0:WINDOW], "an": own[WINDOW:2 * WINDOW]}

            def issue(s):
                for v in range(SELF_STAGE):
                    u = SELF_STAGE * s + v
                    if u <= t:
                        reg = "aw" if u // WINDOW == window["cw"] else "an"
                        j = int(window[reg][u % WINDOW])
                        for hq, h in enumerate(heads):
                            cols_h = slice(h * dh, (h + 1) * dh)
                            ring[s % S, v, 0, hq, :dh] = kc[u, b * K + j, cols_h].float()
                            ring[s % S, v, 1, hq, :dh] = vc[u, b * K + j, cols_h].float()

            state = {h: dict(m=torch.tensor(-math.inf), l=torch.tensor(0.0),
                             acc=torch.zeros(8, 4, epl)) for h in heads}
            for s in range(S):
                issue(s)
            for s in range(nst):
                if SELF_STAGE * s // WINDOW != window["cw"]:
                    window["cw"] += 1
                    w1 = WINDOW * (window["cw"] + 1)
                    window["aw"], window["an"] = window["an"], own[w1:w1 + WINDOW]
                for v in range(min(SELF_STAGE, t + 1 - SELF_STAGE * s)):
                    for hq, h in enumerate(heads):
                        st = state[h]
                        qh = q[n, h * dh:(h + 1) * dh].float()
                        kr, vr = ring[s % S, v, 0, hq], ring[s % S, v, 1, hq]
                        qv = torch.where(valid, qh[cols.clamp(max=dh - 1)], 0.0)
                        kv = torch.where(valid, kr[cols.clamp(max=dh - 1)], 0.0)
                        part = torch.zeros(8, 4)
                        for i in range(epl):
                            part = part + qv[:, :, i] * kv[:, :, i]
                        x = (part[:, 0] + part[:, 2]) + (part[:, 1] + part[:, 3])
                        for off in (4, 2, 1):
                            x = x + x[lanes ^ off]
                        sc = x[0] * scale
                        m_new = torch.maximum(st["m"], sc)
                        cc, p = torch.exp(st["m"] - m_new), torch.exp(sc - m_new)
                        st["l"] = st["l"] * cc + p
                        vv = torch.where(valid, vr[cols.clamp(max=dh - 1)], 0.0)
                        st["acc"] = st["acc"] * cc + p * vv
                        st["m"] = m_new
                issue(s + S)
            for h in heads:
                out = torch.zeros(dh)
                st = state[h]
                out[cols[valid]] = (st["acc"] / st["l"])[valid]
                ctx[n, h * dh:(h + 1) * dh] = out
    return ctx


# (B, K, D, heads, T, t, cache dtype): t = 0 (one stage); dh = 64 in
# float32 (two stages a ring, five stages) and in bfloat16 (four); two
# windows (t = 37) and three (t = 69); K = 1; K = 16 at dh = 128; dh = 25
# (no 16-byte copies on the card); 4, 2, 1 and 6 heads (a warp's four heads
# all live, half, one, and a second warp with two).
CASES = [(2, 2, 16, 4, 9, 0, "float32"), (2, 5, 128, 2, 21, 19, "float32"),
         (1, 5, 128, 2, 21, 20, "bfloat16"), (2, 3, 24, 2, 40, 37, "float32"),
         (3, 1, 32, 1, 7, 6, "float32"), (1, 16, 256, 2, 6, 5, "float32"),
         (2, 2, 50, 2, 9, 8, "bfloat16"), (1, 2, 16, 2, 72, 69, "float32"),
         (2, 3, 48, 6, 11, 10, "float32")]


@pytest.mark.parametrize("B,K,D,H,T,t,dtype", CASES)
def test_self_staging_model_matches_pallas(B, K, D, H, T, t, dtype):
    """The model of the kernel's staging and order against the JAX Pallas
    kernel in interpret mode and the port's plain version, within 1e-5
    (tests/test_torch_transformer_kernels.py's tolerance: float32 sums in
    other orders), on a random ancestry with column t the identity."""
    rs = np.random.RandomState(7 * K + t)
    q = rs.randn(B * K, D).astype(np.float32)
    kc, vc = (rs.randn(T, B * K, D).astype(np.float32) for _ in range(2))
    anc = rs.randint(0, K, (B, K, T)).astype(np.int32)
    anc[:, :, t] = np.arange(K)
    jk, jv = (jnp.asarray(c).astype(dtype) for c in (kc, vc))
    want = j_beam_self(jnp.asarray(q), jk, jv, jnp.asarray(anc), jnp.int32(t), H, K,
                       interpret=True)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(q), torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt),
            torch.from_numpy(anc))
    got = self_model(*args, t, H, K)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    plain = beam_self_attention_reference(*args, t, H, K)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    # On a CPU tensor the wrapper is the plain version.
    assert torch.equal(beam_self_attention(*args, t, H, K), plain)
