"""Context-parallel (frame-sharded) cross-attention for one decode step.

Counterpart of video_captioning_tpu/parallel/context_parallel.py
(``attend_cp``, ``attend_context_parallel``, ``shard_frames``): the frame
axis S of the encoder outputs, their step-invariant projections and the
mask is split over a mesh axis (``config.parallel.context_axis``). Each
rank holds the whole (replicated) query, takes its block of S, computes
the local scores and their max, and the shards combine the softmax with
an ``all_reduce(MAX)`` of the maxima and an ``all_reduce(SUM)`` of the
exponent sums and of the weighted context sums: the blockwise
decomposition of flash and ring attention. The weights come back whole
(an ``all_gather`` of the blocks), as the JAX ``shard_map``'s
``P(None, axis)`` output assembles them.

``models/attention.py`` routes ``attend`` (eval) and ``attend_beam`` here
when ``context_axis`` is set, before the ``use_pallas_attention`` kernel,
as the JAX package does (``models/attention.py:133-140,314``), for
Bahdanau, Luong and multi-head; ``models/transformer.py`` routes the
transformer's cross-attention step to ``cross_attention_step_cp``. The
mesh is the ambient one (``parallel.mesh.set_mesh``) unless one is given.
Every rank of the axis runs the same decode; with one rank the
collectives are skipped.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import Config
from ..models.layers import linear
from .mesh import Mesh, current_mesh

Tensor = torch.Tensor

MASK_FILL = -1e9


def _axis(mesh: Optional[Mesh], axis: str) -> Tuple[int, int, object]:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"context_axis={axis!r} needs a mesh (parallel.mesh.set_mesh or mesh=)")
    return mesh.axis_size(axis), mesh.axis_index(axis), mesh.group(axis)


def shard_frames(x: Tensor, n: int, i: int) -> Tensor:
    """Block ``i`` of ``n`` of a (B, S, ...) tensor's frame axis."""
    S = x.shape[1]
    if S % n:
        raise ValueError(f"{S} frames do not split over a context axis of {n}")
    s = S // n
    return x[:, i * s:(i + 1) * s]


def _all_reduce(x: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    if group is not None:
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather_frames(w: Tensor, group) -> Tensor:
    if group is None:
        return w
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def online_softmax(scores: Tensor, group) -> Tensor:
    """Softmax over the (split) last axis: the global max and the global
    exponent sum combined across the group."""
    m = _all_reduce(scores.amax(dim=-1), group, dist.ReduceOp.MAX)
    e = torch.exp(scores - m[..., None])
    return e / _all_reduce(e.sum(dim=-1), group)[..., None]


def _masked(scores: Tensor, mask_l: Tensor) -> Tensor:
    # mask (B, S_l) against scores (B, ..., S_l)
    idx = (slice(None),) + (None,) * (scores.ndim - 2) + (slice(None),)
    return torch.where(mask_l[idx] > 0, scores, torch.full_like(scores, MASK_FILL))


def attend_cp(config: Config, attn, cache: Dict[str, Tensor], encoder_outputs: Tensor,
              queries: Tensor, encoder_mask: Optional[Tensor], axis: str,
              mesh: Optional[Mesh] = None) -> Tuple[Tensor, Tensor]:
    """queries (B, Q, D), replicated -> context (B, Q, E) and weights
    (B, Q, S), equal to the unsplit attention up to the order of the
    softmax sums."""
    from ..models import attention as A
    from ..models.layers import linear, promote

    n, i, group = _axis(mesh, axis)
    enc_l = shard_frames(encoder_outputs, n, i)
    cache_l = {k: shard_frames(v, n, i) for k, v in cache.items()}
    if encoder_mask is None:
        encoder_mask = torch.ones(encoder_outputs.shape[:2], dtype=encoder_outputs.dtype,
                                  device=encoder_outputs.device)
    mask_l = shard_frames(encoder_mask, n, i)
    if isinstance(attn, A.MultiheadAttention):
        k, v = cache_l["k"], cache_l["v"]  # (B, S_l, H, hd)
        B, _, H, hd = k.shape
        Q = queries.shape[1]
        q = linear(attn.query_linear, queries).reshape(B, Q, H, hd)
        s = torch.einsum("bqhd,bshd->bqhs", q, k).float() / math.sqrt(hd)
        w = online_softmax(_masked(s, mask_l), group)  # (B, Q, H, S_l)
        ctx = torch.einsum("bqhs,bshd->bqhd", w.to(v.dtype), v).reshape(B, Q, H * hd)
        ctx = linear(attn.output_linear, _all_reduce(ctx, group))
        out_dtype = queries.dtype
        return ctx.to(out_dtype), _gather_frames(w.mean(dim=2), group).to(out_dtype)
    if isinstance(attn, A.BahdanauAttention):
        dec_proj = linear(attn.decoder_projection, queries)
        scores = A._bahdanau_scores(config, attn, cache_l["enc_proj"][:, None, :, :],
                                    dec_proj[:, :, None, :])
    else:
        scores = A._luong_scores(attn, cache_l, enc_l, queries)
    w = online_softmax(_masked(scores, mask_l), group)
    wp, e = promote(w, enc_l)
    return _all_reduce(wp @ e, group), _gather_frames(w, group)


def attend_context_parallel(config: Config, attn, encoder_outputs: Tensor,
                            decoder_hidden: Tensor, encoder_mask: Optional[Tensor],
                            mesh: Optional[Mesh] = None,
                            axis: str = "model") -> Tuple[Tensor, Tensor]:
    """Bahdanau attention for (B, D) queries with the frame axis split over
    ``axis``: the JAX package's legacy Bahdanau-only entry over
    :func:`attend_cp`. Returns context (B, E) and weights (B, S)."""
    from ..models import attention as A
    from ..models.layers import linear

    if not isinstance(attn, A.BahdanauAttention):
        raise ValueError("attend_context_parallel is the bahdanau-only legacy entry; "
                         "use attend_cp for other attention types")
    cache = {"enc_proj": linear(attn.encoder_projection, encoder_outputs)}
    ctx, w = attend_cp(config, attn, cache, encoder_outputs, decoder_hidden[:, None],
                       encoder_mask, axis, mesh)
    return ctx[:, 0], w[:, 0]


def cross_attention_step_cp(p, x: Tensor, ck: Tensor, cv: Tensor,
                            encoder_mask: Optional[Tensor], heads: int, axis: str,
                            mesh: Optional[Mesh] = None) -> Tuple[Tensor, Tensor]:
    """The transformer's one-query cross-attention (the JAX
    ``_cross_attn_step_cp``) with the frame axis of the (B, S, D) keys and
    values split over ``axis``. Returns (out (N, D), head-mean weights
    (N, S)) for N = B*K rows."""
    n, i, group = _axis(mesh, axis)
    B, S, D = ck.shape
    K = x.shape[0] // B
    dh = D // heads
    if encoder_mask is None:
        encoder_mask = torch.ones((B, S), dtype=x.dtype, device=x.device)
    ck_l, cv_l = shard_frames(ck, n, i), shard_frames(cv, n, i)
    mask_l = shard_frames(encoder_mask, n, i)
    q = linear(p.wq, x).reshape(B, K, heads, dh)
    scores = torch.einsum("bkhd,bshd->bkhs", q.to(ck.dtype).float(),
                          ck_l.float().reshape(B, -1, heads, dh)) / math.sqrt(dh)
    w = online_softmax(_masked(scores, mask_l), group)  # (B, K, h, S_l)
    ctx = torch.einsum("bkhs,bshd->bkhd", w.to(cv.dtype).float(),
                       cv_l.float().reshape(B, -1, heads, dh)).to(x.dtype)
    ctx = _all_reduce(ctx.reshape(B * K, D), group)
    w = _gather_frames(w.mean(dim=2).reshape(B * K, -1), group)
    return linear(p.wo, ctx), w.to(x.dtype)
