"""The transformer family's beam-decode attention under
``kernels.transformer_fused_beam_attn``.

Counterpart of video_captioning_tpu/ops/transformer_attn_pallas.py:

* ``beam_self_attention`` (q (B*K, D), this layer's time-major caches
  ``k_lyr``/``v_lyr`` (T, B*K, D) with row t already written, the
  ancestry ``anc`` (B, K, T) int32): beam k of clip b attends over the
  physical rows (tau, b*K + anc[b, k, tau]) for tau <= t; returns the
  context (B*K, D) before ``wo``.
* ``beam_cross_attention`` (q (B*K, D), the un-expanded encoder keys and
  values ``ck``/``cv`` (B, S, D), the frame mask (B, S) or None for all
  valid): returns the context (B*K, D) and the softmax weights averaged
  over the heads (B*K, S).

q is float32 or bfloat16 and the outputs are in q's dtype (the JAX
kernels' ``out_shape``: a bfloat16 query is the bfloat16 beam state's); the
caches and cross keys/values may be float32 or bfloat16
(``kernels.transformer_cache_bf16``, ``transformer_cross_kv_bf16``, the
bfloat16 state). Scores, softmax and sums are float32 whatever the dtypes,
and a bfloat16 context is rounded once from them. The bfloat16 head-mean
weights follow the JAX kernel's grid (``head_mean``). Masked scores are
-1e9, not -inf, so a fully masked row gets uniform weights. On a CUDA
tensor each wrapper launches its kernel in ``csrc/transformer_attn.cu``;
on a CPU tensor it runs its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor

MASK_FILL = -1e9
MAX_BEAMS = 16
MAX_HEAD_DIM = 128
CACHE_DTYPES = (torch.float32, torch.bfloat16)
QUERY_DTYPES = (torch.float32, torch.bfloat16)

# The cross kernel's plan (csrc/transformer_attn.cu: cross_layout).
CROSS_SMEM = 232448           # bytes a CTA may hold on Hopper (227 KB)
CROSS_RESIDENT_SMEM = 24576   # a head's whole slice staged at once up to this
CROSS_RING_FRAMES = 32        # frames a chunk of the ring
CROSS_SLOTS = 2               # the ring's slots (kSlots)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def cross_smem(K: int, H: int, D: int, S: int, kv_bytes: int, vec: bool, FC: int) -> int:
    """Shared memory of a cross CTA (csrc/transformer_attn.cu:
    cross_layout): the ring's mbarriers; with one chunk a tensor (FC = S) a
    slot of key rows and one of value rows, else CROSS_SLOTS slots of FC key
    rows (key rows dh + 16 bytes, value rows dh elements with vector copies,
    both dh + 1 elements without); and the K queries' head slice, staged as
    float32 whatever q's dtype (widened as it is loaded)."""
    dh = D // H
    ldk = dh + 16 // kv_bytes if vec else dh + 1
    ldv = dh if vec else dh + 1
    slot = _round16(FC * ldk * kv_bytes)
    staged = slot + _round16(S * ldv * kv_bytes) if FC >= S else CROSS_SLOTS * slot
    return _round16(8 * CROSS_SLOTS) + staged + _round16(4 * K * dh)


@functools.lru_cache(maxsize=256)
def cross_plan(K: int, H: int, D: int, S: int, kv_bytes: int, vec: bool) -> dict:
    """The cross kernel's plan for one shape. One CTA a (clip, head) of
    32 K threads, all S frames of the clip in it (frames are never split
    over CTAs), then the head-mean launch. The head's keys and values
    staged whole (FC = S, ``nch`` = 1 chunk of each, both in flight from
    entry) where they take at most CROSS_RESIDENT_SMEM or S is at most one
    ring chunk; else CROSS_RING_FRAMES-frame chunks through the
    CROSS_SLOTS slots, so that CTAs stay small and many fit an SM (at the
    main shape in float32 eleven, against five resident, which measured
    slower on an H100; PERF.md)."""
    whole = cross_smem(K, H, D, S, kv_bytes, vec, S)
    if S <= CROSS_RING_FRAMES or whole <= CROSS_RESIDENT_SMEM:
        FC, nch = S, 1
    else:
        FC, nch = CROSS_RING_FRAMES, -(-S // CROSS_RING_FRAMES)
    return dict(FC=FC, nch=nch, smem=cross_smem(K, H, D, S, kv_bytes, vec, FC))


# The self kernel's plan (csrc/transformer_attn.cu: self_layout).
SELF_HEADS = 4           # heads a warp (a CTA), 8 lanes each
SELF_PAD = 8             # elements after each head's row slice in a stage
SELF_STAGE = 4           # positions a stage of the ring
SELF_MAX_STAGES = 3      # stages a ring at most
SELF_BUDGET = 20480      # a ring's bytes at most, past two stages


@functools.lru_cache(maxsize=256)
def self_plan(K: int, dh: int, t: int, cache_bytes: int) -> dict:
    """The self kernel's plan for one shape. One warp a CTA for each beam
    and SELF_HEADS heads (8 lanes a head); it streams its beam's rows (the
    heads' key and value slices, each padded by SELF_PAD elements) for
    positions 0..t through a ring of ``stages`` stages of SELF_STAGE
    positions: the fewer of the prefix's stages and the most, up to
    SELF_MAX_STAGES, that take at most SELF_BUDGET bytes (at least 2). At
    the main shape (K = 5, dh = 64, t = 19) two stages in float32 (18 KB a
    CTA) and three in bfloat16 (13.5 KB): twelve CTAs an SM or more, where
    the 1280 CTAs need ten for one wave of the H100's 132 SMs. ``smem``:
    the ring."""
    if not (1 <= K <= MAX_BEAMS and 1 <= dh <= MAX_HEAD_DIM and t >= 0
            and cache_bytes in (2, 4)):
        raise ValueError(f"self_plan: K = {K}, dh = {dh}, t = {t}, {cache_bytes}-byte caches "
                         f"outside the kernel's domain (K <= {MAX_BEAMS}, dh <= "
                         f"{MAX_HEAD_DIM}, t >= 0, float32 or bfloat16)")
    nst = t // SELF_STAGE + 1
    stage = SELF_STAGE * 2 * SELF_HEADS * (dh + SELF_PAD) * cache_bytes
    S = 2
    while S < SELF_MAX_STAGES and S < nst and (S + 1) * stage <= SELF_BUDGET:
        S += 1
    stages = min(S, nst)
    return dict(stages=stages, smem=stages * stage)


def kernel_self_plan(K: int, dh: int, t: int, cache_bytes: int) -> dict:
    """The plan the card's launcher takes at a shape
    (``vct_beam_self_plan``), to hold against ``self_plan``. Needs the
    built library (nvcc)."""
    out = (ctypes.c_int * 2)()
    rc = _kernel_lib().vct_beam_self_plan(K, dh, t, int(cache_bytes == 2), out)
    if rc != 0:
        raise ValueError(f"vct_beam_self_plan refused K = {K}, dh = {dh}, t = {t} ({rc})")
    return dict(stages=out[0], smem=out[1])


def cross_vec(ck: Tensor, cv: Tensor, num_heads: int) -> bool:
    """Whether the cross kernel copies and reads 16 bytes at a time: a
    head's dh elements and a frame's D elements multiples of 16 bytes, and
    16-byte aligned keys and values."""
    esz, D = ck.element_size(), ck.shape[-1]
    return ((D // num_heads * esz) % 16 == 0 and (D * esz) % 16 == 0
            and ck.data_ptr() % 16 == 0 and cv.data_ptr() % 16 == 0)


def gather_beam_prefix(cache: Tensor, anc: Tensor, t: int) -> Tensor:
    """Rows 0..t of a (T, B*K, D) physical-slot cache as each beam sees
    them: out[tau, b*K + k] = cache[tau, b*K + anc[b, k, tau]]."""
    B, K, _ = anc.shape
    D = cache.shape[-1]
    base = torch.arange(B, device=anc.device)[:, None, None] * K
    rows = (base + anc[:, :, :t + 1].long()).permute(2, 0, 1).reshape(t + 1, B * K)
    return torch.gather(cache[:t + 1], 1, rows[..., None].expand(t + 1, B * K, D))


def heads_per_block(D: int, num_heads: int) -> int:
    """Heads a block of the JAX cross kernel's grid
    (``transformer_attn_pallas.py:beam_cross_attention``): 128 lanes of
    heads where D and the head width allow, else all of them."""
    dh = D // num_heads
    return 128 // dh if D % 128 == 0 and 128 % dh == 0 else num_heads


def head_mean(w: Tensor, dtype: torch.dtype, hpb: int) -> Tensor:
    """The head-mean weights (..., S) in ``dtype`` of float32 softmax
    weights (..., H, S). Float32: the mean. Bfloat16: the JAX kernel's
    rounding, whose grid visits ``hpb`` heads (``heads_per_block``) at a
    time: each block's float32 sum in head order, divided by H, rounded;
    the blocks' parts added in block order, each sum rounded."""
    H = w.shape[-2]
    if dtype == torch.float32:
        return w.mean(dim=-2)
    out = None
    for h0 in range(0, H, hpb):
        acc = torch.zeros_like(w[..., 0, :])
        for h in range(h0, h0 + hpb):
            acc = acc + w[..., h, :]
        part = (acc / H).to(dtype)
        out = part if out is None else (out.float() + part.float()).to(dtype)
    return out


def beam_self_attention_reference(q: Tensor, k_lyr: Tensor, v_lyr: Tensor, anc: Tensor,
                                  t: int, num_heads: int, num_beams: int) -> Tensor:
    """Plain version: gather each beam's prefix, float32 scores, softmax
    and context, the context rounded once to q's dtype."""
    N, D = q.shape
    dh = D // num_heads
    kh = gather_beam_prefix(k_lyr, anc, t).float().reshape(t + 1, N, num_heads, dh)
    vh = gather_beam_prefix(v_lyr, anc, t).float().reshape(t + 1, N, num_heads, dh)
    qh = q.float().reshape(N, num_heads, dh)
    scores = torch.einsum("nhd,tnhd->nht", qh, kh) / math.sqrt(dh)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("nht,tnhd->nhd", w, vh).reshape(N, D).to(q.dtype)


def beam_cross_attention_reference(q: Tensor, ck: Tensor, cv: Tensor, mask: Optional[Tensor],
                                   num_heads: int, num_beams: int) -> Tuple[Tensor, Tensor]:
    """Plain version: the K beams of a clip broadcast over its keys and
    values; float32 masked softmax, context (rounded once a head to q's
    dtype), and the head-mean weights (``head_mean``)."""
    N, D = q.shape
    B, S, _ = ck.shape
    K, dh = num_beams, D // num_heads
    qh = q.float().reshape(B, K, num_heads, dh)
    kh = ck.float().reshape(B, S, num_heads, dh)
    vh = cv.float().reshape(B, S, num_heads, dh)
    scores = torch.einsum("bkhd,bshd->bkhs", qh, kh) / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores,
                             torch.full_like(scores, MASK_FILL))
    w = torch.softmax(scores, dim=-1)  # (B, K, h, S)
    ctx = torch.einsum("bkhs,bshd->bkhd", w, vh).reshape(N, D)
    weights = head_mean(w, q.dtype, heads_per_block(D, num_heads))
    return ctx.to(q.dtype), weights.reshape(N, S).to(q.dtype)


def _check_common(what: str, q: Tensor, num_heads: int, num_beams: int,
                  tensors: dict) -> None:
    N, D = q.shape if q.dim() == 2 else (0, 0)
    if q.dim() != 2 or q.dtype not in QUERY_DTYPES:
        raise ValueError(f"{what} takes q (B*K, D) float32 or bfloat16, got {q.dtype} "
                         f"{tuple(q.shape)}")
    if not 1 <= num_beams <= MAX_BEAMS or N % num_beams:
        raise ValueError(f"{what}: K = {num_beams} must be in [1, {MAX_BEAMS}] and divide "
                         f"B*K = {N}")
    if num_heads < 1 or D % num_heads or D // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"{what}: {num_heads} heads must divide D = {D} with a head width "
                         f"of at most {MAX_HEAD_DIM}")
    for name, x in {"q": q, **tensors}.items():
        if x is None:
            continue
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what} takes a contiguous {name}")


def _check_self(q, k_lyr, v_lyr, anc, t, num_heads, num_beams) -> None:
    _check_common("beam_self_attention", q, num_heads, num_beams,
                  {"k_lyr": k_lyr, "v_lyr": v_lyr, "anc": anc})
    N, D = q.shape
    T = k_lyr.shape[0] if k_lyr.dim() == 3 else 0
    for name, c in (("k_lyr", k_lyr), ("v_lyr", v_lyr)):
        if tuple(c.shape) != (T, N, D) or c.dtype not in CACHE_DTYPES or c.dtype != k_lyr.dtype:
            raise ValueError(f"beam_self_attention takes {name} ({T}, {N}, {D}) float32 or "
                             f"bfloat16 like k_lyr, got {c.dtype} {tuple(c.shape)}")
    if tuple(anc.shape) != (N // num_beams, num_beams, T) or anc.dtype != torch.int32:
        raise ValueError(f"beam_self_attention takes anc ({N // num_beams}, {num_beams}, {T}) "
                         f"int32, got {anc.dtype} {tuple(anc.shape)}")
    if not 0 <= t < T:
        raise ValueError(f"beam_self_attention: t = {t} outside the cache's {T} rows")


def _check_cross(q, ck, cv, mask, num_heads, num_beams) -> None:
    _check_common("beam_cross_attention", q, num_heads, num_beams,
                  {"ck": ck, "cv": cv, "mask": mask})
    N, D = q.shape
    B = N // num_beams
    S = ck.shape[1] if ck.dim() == 3 else 0
    for name, c in (("ck", ck), ("cv", cv)):
        if tuple(c.shape) != (B, S, D) or c.dtype not in CACHE_DTYPES or c.dtype != ck.dtype:
            raise ValueError(f"beam_cross_attention takes {name} ({B}, {S}, {D}) float32 or "
                             f"bfloat16 like ck, got {c.dtype} {tuple(c.shape)}")
    if mask is not None and (tuple(mask.shape) != (B, S) or mask.dtype != torch.float32):
        raise ValueError(f"beam_cross_attention takes mask ({B}, {S}) float32, got "
                         f"{mask.dtype} {tuple(mask.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("transformer_attn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vct_beam_self_attention.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.vct_beam_self_attention.restype = i32
    lib.vct_beam_cross_attention.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
    lib.vct_beam_cross_attention.restype = i32
    lib.vct_beam_self_plan.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.vct_beam_self_plan.restype = i32
    return lib


def _on_card(what: str, q: Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {q.device}")
    return True


def beam_self_attention(q: Tensor, k_lyr: Tensor, v_lyr: Tensor, anc: Tensor, t: int,
                        num_heads: int, num_beams: int) -> Tensor:
    """Context (B*K, D). CUDA: the kernel (its staging from ``self_plan``,
    which the launcher computes), on the current stream, no sync. CPU: the
    plain version."""
    if tracing():
        return torch.ops.vct.beam_self_attention(q, k_lyr, v_lyr, anc, t, num_heads, num_beams)
    _check_self(q, k_lyr, v_lyr, anc, t, num_heads, num_beams)
    if not _on_card("beam_self_attention", q):
        return beam_self_attention_reference(q, k_lyr, v_lyr, anc, t, num_heads, num_beams)
    lib = _kernel_lib()
    N, D = q.shape
    ctx = torch.empty_like(q)
    if N == 0:
        return ctx
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vct_beam_self_attention(
            q.data_ptr(), k_lyr.data_ptr(), v_lyr.data_ptr(), anc.data_ptr(), ctx.data_ptr(),
            int(k_lyr.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16),
            N // num_beams, num_beams, num_heads, D, k_lyr.shape[0], t, stream,
        )
    check_launch(lib, rc, "beam_self_attention")
    beam_self_attention.launches += 1
    return ctx


def beam_cross_attention(q: Tensor, ck: Tensor, cv: Tensor, mask: Optional[Tensor],
                         num_heads: int, num_beams: int) -> Tuple[Tensor, Tensor]:
    """Context (B*K, D) and head-mean weights (B*K, S). CUDA: the kernel
    (its staging from ``cross_plan``) and its head-mean launch, on the
    current stream, no sync. CPU: the plain version."""
    if tracing():
        return torch.ops.vct.beam_cross_attention(q, ck, cv, mask, num_heads, num_beams)
    _check_cross(q, ck, cv, mask, num_heads, num_beams)
    if not _on_card("beam_cross_attention", q):
        return beam_cross_attention_reference(q, ck, cv, mask, num_heads, num_beams)
    lib = _kernel_lib()
    N, D = q.shape
    S = ck.shape[1]
    ctx = torch.empty_like(q)
    weights = torch.empty((N, S), dtype=q.dtype, device=q.device)
    if N == 0 or S == 0:
        return ctx, weights
    vec = cross_vec(ck, cv, num_heads)
    plan = cross_plan(num_beams, num_heads, D, S, ck.element_size(), vec)
    per_head = torch.empty((N, num_heads, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vct_beam_cross_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
            None if mask is None else mask.data_ptr(), ctx.data_ptr(), per_head.data_ptr(),
            weights.data_ptr(), int(ck.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16),
            N // num_beams, num_beams, num_heads, D, S, int(vec), plan["FC"],
            heads_per_block(D, num_heads), stream,
        )
    check_launch(lib, rc, "beam_cross_attention")
    beam_cross_attention.launches += 1
    return ctx, weights


beam_self_attention.launches = 0
beam_cross_attention.launches = 0
