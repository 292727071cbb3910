"""Pre-LN encoder-decoder transformer captioner: the teacher-forced forward
(training and eval) and the incremental decode steps of greedy and beam
search.

Counterpart of video_captioning_tpu/models/transformer.py. The modules
mirror the JAX parameter pytree (``encoder.blocks.i.{ln1, self_attn.{wq,
wk, wv, wo}, ln2, mlp.{fc1, fc2}}``, ``decoder.{embedding, pos_embedding,
blocks, ln_f, output_projection}``); layer norms hold ``weight``/``bias``
where JAX has ``scale``/``bias``. Layer norms take float32 statistics with
the biased variance and eps 1e-5, and the MLP's GELU is the tanh form
(``jax.nn.gelu``'s default).

Decoding keeps per-layer, time-major (T, N, D) self-attention caches for
every beam width (the JAX package stacks them for K = 1, a choice about
the TPU's schedule; the values are the same). Each step writes row ``t``
of every layer's caches in place. Beam search at K >= 2 rebeams lazily:
physical cache rows are never moved, and ``state["anc"]`` (B, K, T) names
the physical slot that holds beam k's entry at position tau. Under
``kernels.transformer_fused_beam_attn`` the beam step's self- and
cross-attention run the kernels of ``ops/transformer_attn.py``
(``kernels.transformer_fused_cross_attn`` alone routes the
cross-attention); otherwise both run here, as the JAX package's XLA path
computes them, including its rounding of the query and the softmax
weights to the cache dtype under bfloat16 caches.

Parameters may be bfloat16 (a predictor with ``compute_dtype="bfloat16"``)
and activations float32 or bfloat16, mixed as the JAX package mixes them:
every linear is ``layers.linear`` (``matmul_default``: a float32 activation
against a bfloat16 weight is rounded to bfloat16 and summed to a float32
result; bfloat16 against bfloat16 stays bfloat16), a layer norm takes
float32 statistics and returns its input's dtype, and sums of mixed
operands promote. The decode steps take the residual stream's dtype from
the caller (``state_dtype``, as the JAX family adapter passes it), not from
the cross keys and values, which ``kernels.transformer_cross_kv_bf16``
stores in bfloat16 whatever the stream's dtype. In float32 every function
computes what it did before.

In training (``train=True`` with a ``torch.Generator``) dropout at rate
``transformer_dropout`` runs where the JAX package applies it: on the
embedding and on each residual branch (after self-attention and the MLP in
an encoder block; after self-attention, cross-attention and the MLP in a
decoder block), drawn from the caller's generator in that order. The
decode steps take no dropout.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config

from ..ops.transformer_attn import beam_cross_attention, beam_self_attention, gather_beam_prefix
from ..parallel.context_parallel import cross_attention_step_cp
from .layers import Int8Linear, affine, dropout, linear

Tensor = torch.Tensor
# One fused (3D, D) weight and (3D,) bias per decoder block (None for a
# block in W8A8 form), or None.
MergedQKV = Optional[Sequence[Optional[Tuple[Tensor, Tensor]]]]

NEG_INF = -1e9
LN_EPS = 1e-5


class Attention(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.wq = nn.Linear(d_model, d_model)
        self.wk = nn.Linear(d_model, d_model)
        self.wv = nn.Linear(d_model, d_model)
        self.wo = nn.Linear(d_model, d_model)


class MLP(nn.Module):
    def __init__(self, d_model: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(d_model, ratio * d_model)
        self.fc2 = nn.Linear(ratio * d_model, d_model)

    def forward(self, x: Tensor) -> Tensor:
        return linear(self.fc2, F.gelu(linear(self.fc1, x), approximate="tanh"))


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, ratio: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = Attention(d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = MLP(d_model, ratio)


class DecoderBlock(nn.Module):
    def __init__(self, d_model: int, ratio: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = Attention(d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = Attention(d_model)
        self.ln3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = MLP(d_model, ratio)


class TransformerEncoder(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        D = m.decoder_hidden_dim
        self.feature_projection = nn.Linear(m.cnn_feature_dim, D)
        self.pos_embedding = nn.Parameter(torch.zeros(m.video_sequence_length, D))
        self.blocks = nn.ModuleList(EncoderBlock(D, m.transformer_mlp_ratio)
                                    for _ in range(m.transformer_num_layers))
        self.ln_f = nn.LayerNorm(D, eps=LN_EPS)


class TransformerDecoder(nn.Module):
    def __init__(self, config: Config, vocab_size: int):
        super().__init__()
        m = config.model
        D = m.decoder_hidden_dim
        self.embedding = nn.Embedding(vocab_size, D)
        self.pos_embedding = nn.Parameter(torch.zeros(m.max_sequence_length + 1, D))
        self.blocks = nn.ModuleList(DecoderBlock(D, m.transformer_mlp_ratio)
                                    for _ in range(m.transformer_decoder_layers))
        self.ln_f = nn.LayerNorm(D, eps=LN_EPS)
        self.output_projection = nn.Linear(D, vocab_size)


def layer_norm(ln: nn.LayerNorm, x: Tensor) -> Tensor:
    """The JAX package's layer norm whatever the dtypes: statistics, scale
    and bias in float32 (biased variance, eps 1e-5), the result in x's
    dtype. ``nn.LayerNorm`` itself where x and the parameters are float32
    (the float32 path's bits)."""
    if x.dtype == ln.weight.dtype == torch.float32:
        return ln(x)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(x.dtype)


# --------------------------------------------------------------------------
# Full-sequence attention, encoder, teacher forcing
# --------------------------------------------------------------------------


def _mha(p: Attention, q_in: Tensor, kv_in: Tensor, num_heads: int,
         mask: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Multi-head attention; mask (B or 1, Tq, Tk), 1 = attend. Returns the
    output (B, Tq, D) and the head-mean weights (B, Tq, Tk)."""
    B, Tq, D = q_in.shape
    Tk = kv_in.shape[1]
    dh = D // num_heads
    q = linear(p.wq, q_in).reshape(B, Tq, num_heads, dh)
    k = linear(p.wk, kv_in).reshape(B, Tk, num_heads, dh)
    v = linear(p.wv, kv_in).reshape(B, Tk, num_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[:, None] > 0, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
    return linear(p.wo, ctx.reshape(B, Tq, D)), weights.mean(dim=1).to(q_in.dtype)


def apply_transformer_encoder(enc: TransformerEncoder, config: Config, video_features: Tensor,
                              video_mask: Optional[Tensor], *, train: bool = False,
                              generator: Optional[torch.Generator] = None
                              ) -> Tuple[Tensor, Tensor]:
    """Returns (encoder_outputs (B, S, D), final (B, D)); ``final`` is the
    mean over valid frames."""
    heads = config.model.transformer_num_heads
    p_drop = config.model.transformer_dropout
    B, S, _ = video_features.shape
    if S > enc.pos_embedding.shape[0]:
        raise ValueError(
            f"transformer encoder got {S} frames but its learned position table covers "
            f"{enc.pos_embedding.shape[0]} (model.video_sequence_length at init); resample "
            "the video or re-init with a larger video_sequence_length"
        )
    x = linear(enc.feature_projection, video_features)
    x = x + enc.pos_embedding[None, :S].to(x.dtype)
    x = dropout(x, p_drop, generator, train)
    attn_mask = None if video_mask is None else video_mask[:, None, :].expand(B, S, S)
    for blk in enc.blocks:
        h_in = layer_norm(blk.ln1, x)
        h, _ = _mha(blk.self_attn, h_in, h_in, heads, attn_mask)
        x = x + dropout(h, p_drop, generator, train)
        x = x + dropout(blk.mlp(layer_norm(blk.ln2, x)), p_drop, generator, train)
    x = layer_norm(enc.ln_f, x)
    if video_mask is None:
        return x, x.mean(dim=1)
    msk = video_mask.to(x.dtype)[:, :, None]
    return x, (x * msk).sum(dim=1) / torch.clamp(msk.sum(dim=1), min=1.0)


def apply_transformer_decoder(dec: TransformerDecoder, config: Config, encoder_outputs: Tensor,
                              input_tokens: Tensor, encoder_mask: Optional[Tensor], *,
                              train: bool = False,
                              generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
    """Teacher forcing in one pass: ``logits`` (B, T, V) and the last
    block's head-mean cross-attention ``attention_weights`` (B, T, S)."""
    heads = config.model.transformer_num_heads
    p_drop = config.model.transformer_dropout
    B, T = input_tokens.shape
    S = encoder_outputs.shape[1]
    x = dec.embedding(input_tokens).to(encoder_outputs.dtype)
    x = x + dec.pos_embedding[None, :T].to(x.dtype)
    x = dropout(x, p_drop, generator, train)
    causal = torch.tril(torch.ones((1, T, T), device=x.device))
    cross_mask = None if encoder_mask is None else encoder_mask[:, None, :].expand(B, T, S)
    cross_w = None
    for blk in dec.blocks:
        h_in = layer_norm(blk.ln1, x)
        h, _ = _mha(blk.self_attn, h_in, h_in, heads, causal)
        x = x + dropout(h, p_drop, generator, train)
        h, cross_w = _mha(blk.cross_attn, layer_norm(blk.ln2, x), encoder_outputs, heads,
                          cross_mask)
        x = x + dropout(h, p_drop, generator, train)
        x = x + dropout(blk.mlp(layer_norm(blk.ln3, x)), p_drop, generator, train)
    return {"logits": linear(dec.output_projection, layer_norm(dec.ln_f, x)),
            "attention_weights": cross_w}


# --------------------------------------------------------------------------
# Incremental decode: KV caches, one token per step
# --------------------------------------------------------------------------


def precompute_cross_kv(dec: TransformerDecoder,
                        encoder_outputs: Tensor) -> Dict[str, List[Tensor]]:
    """Each block's cross-attention keys and values, once per generation
    call; (B, S, D) each, shared by a clip's beams."""
    return {"k": [linear(blk.cross_attn.wk, encoder_outputs) for blk in dec.blocks],
            "v": [linear(blk.cross_attn.wv, encoder_outputs) for blk in dec.blocks]}


def merge_self_attn_qkv(dec: TransformerDecoder) -> List[Optional[Tuple[Tensor, Tensor]]]:
    """Each block's self-attention wq, wk, wv as one (3D, D) linear, so a
    decode step projects q, k and v in one GEMM (kernels.transformer_merge_qkv,
    beam search only, as in the JAX package). Each output column keeps its
    own dot product; a GEMM library may block the merged product otherwise
    than three separate ones, so values may differ in the last bits. A
    block quantized to W8A8 (``models/quantize.py``, level ``full``) is left
    split, as in the JAX package: None in its place."""
    merged: List[Optional[Tuple[Tensor, Tensor]]] = []
    for blk in dec.blocks:
        sa = blk.self_attn
        if isinstance(sa.wq, Int8Linear):
            merged.append(None)
            continue
        merged.append((torch.cat([sa.wq.weight, sa.wk.weight, sa.wv.weight]),
                       torch.cat([sa.wq.bias, sa.wk.bias, sa.wv.bias])))
    return merged


def _qkv_proj(p: Attention, x: Tensor, wqkv: Optional[Tuple[Tensor, Tensor]]):
    if wqkv is not None:
        return affine(x, *wqkv).split(x.shape[-1], dim=-1)
    return linear(p.wq, x), linear(p.wk, x), linear(p.wv, x)


def init_decode_state(dec: TransformerDecoder, config: Config, batch: int, dtype: torch.dtype,
                      device: torch.device, max_positions: Optional[int] = None,
                      cache_dtype: Optional[torch.dtype] = None) -> Dict[str, List[Tensor]]:
    """Zeroed per-layer time-major (T, batch, D) caches under "k" and "v",
    T = max(max_sequence_length + 1, max_positions). Positions past the
    learned position table reuse its last row (logged)."""
    T = config.model.max_sequence_length + 1
    if max_positions is not None:
        T = max(T, max_positions)
    pos_rows = dec.pos_embedding.shape[0]
    if T > pos_rows:
        logging.getLogger(__name__).warning(
            "decoding %d positions but the learned position table has %d rows; positions "
            ">= %d reuse the last row (repetitive long tails likely: re-init with a larger "
            "max_sequence_length, or use the lstm family which decodes any length exactly)",
            T, pos_rows, pos_rows,
        )
    D = config.model.decoder_hidden_dim
    cdt = dtype if cache_dtype is None else cache_dtype

    def zeros():
        return [torch.zeros((T, batch, D), dtype=cdt, device=device) for _ in dec.blocks]

    return {"k": zeros(), "v": zeros()}


def init_beam_ancestry(batch: int, num_beams: int, max_positions: int,
                       device: torch.device) -> Tensor:
    """(B, K, T) int32 ancestry; the beam step writes column t before use
    and the rebeam composes only what later steps read (columns <= t)."""
    return torch.zeros((batch, num_beams, max_positions), dtype=torch.int32, device=device)


def _project_and_write(p: Attention, x: Tensor, k_lyr: Tensor, v_lyr: Tensor, t: int,
                       wqkv) -> Tensor:
    """q, k, v of this step; k and v go into row t of the caches (in
    place). Returns q."""
    q, k_t, v_t = _qkv_proj(p, x, wqkv)
    k_lyr[t] = k_t.to(k_lyr.dtype)
    v_lyr[t] = v_t.to(v_lyr.dtype)
    return q


def _operand(x: Tensor, dtype: torch.dtype, attn_f32: bool) -> Tensor:
    """An attention product's operand as float32: rounded to the stored
    keys' or values' ``dtype`` first, as the JAX XLA path casts it, unless
    ``kernels.transformer_attn_dots_f32`` keeps it whole."""
    return x.float() if attn_f32 else x.to(dtype).float()


def _prefix_attention(q: Tensor, k_rows: Tensor, v_rows: Tensor, heads: int,
                      out_dtype: torch.dtype, attn_f32: bool = False) -> Tensor:
    """One query a row over (t + 1, N, D) key and value rows in the cache
    dtype. The query and the softmax weights are rounded to that dtype
    before their products (``_operand``); the sums are float32 and the
    context is returned in ``out_dtype`` (the attention input's, the JAX
    dots' ``preferred_element_type``)."""
    N, D = q.shape
    dh = D // heads
    cdt, T = k_rows.dtype, k_rows.shape[0]
    qh = _operand(q, cdt, attn_f32).reshape(N, heads, dh)
    kh = k_rows.float().reshape(T, N, heads, dh)
    w = torch.softmax(torch.einsum("nhd,tnhd->nht", qh, kh) / math.sqrt(dh), dim=-1)
    ctx = torch.einsum("nht,tnhd->nhd", _operand(w, cdt, attn_f32),
                       v_rows.float().reshape(T, N, heads, dh))
    return ctx.reshape(N, D).to(out_dtype)


def _cached_self_attn(p: Attention, x: Tensor, k_lyr: Tensor, v_lyr: Tensor, t: int,
                      heads: int, wqkv=None, attn_f32: bool = False) -> Tensor:
    """One-query self-attention over rows 0..t of this layer's caches, after
    writing row t; positions > t would weigh exactly 0, so only the prefix
    is read."""
    q = _project_and_write(p, x, k_lyr, v_lyr, t, wqkv)
    return linear(p.wo, _prefix_attention(q, k_lyr[:t + 1], v_lyr[:t + 1], heads, x.dtype,
                                          attn_f32))


def _cached_self_attn_beam(p: Attention, x: Tensor, k_lyr: Tensor, v_lyr: Tensor,
                           anc: Tensor, t: int, heads: int, wqkv=None,
                           attn_f32: bool = False) -> Tensor:
    """Ancestry-indexed one-query self-attention (lazy rebeam): beam k reads
    the physical rows ``gather_beam_prefix`` selects. The JAX XLA path scores
    all K slots and selects with a one-hot product, which adds exact zeros;
    the gather selects the same values."""
    q = _project_and_write(p, x, k_lyr, v_lyr, t, wqkv)
    return linear(p.wo, _prefix_attention(q, gather_beam_prefix(k_lyr, anc, t),
                                          gather_beam_prefix(v_lyr, anc, t), heads, x.dtype,
                                          attn_f32))


def _cached_self_attn_beam_fused(p: Attention, x: Tensor, k_lyr: Tensor, v_lyr: Tensor,
                                 anc: Tensor, t: int, heads: int, num_beams: int,
                                 wqkv=None) -> Tensor:
    """The same through the ``beam_self_attention`` kernel: the query as
    projected (float32 or bfloat16), float32 softmax whatever the cache
    dtype, the context in the query's dtype."""
    q = _project_and_write(p, x, k_lyr, v_lyr, t, wqkv)
    return linear(p.wo, beam_self_attention(q.contiguous(), k_lyr, v_lyr, anc, t, heads,
                                            num_beams))


def _cross_attn_step(p: Attention, x: Tensor, ck: Tensor, cv: Tensor,
                     encoder_mask: Optional[Tensor], heads: int,
                     attn_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """One-query cross-attention; the N = B*K rows broadcast over the
    un-expanded (B, S, D) keys and values. Returns (out (N, D), head-mean
    weights (N, S)). Under ``kernels.transformer_cross_kv_bf16`` the keys
    and values are bfloat16 and the query and weights are rounded to it at
    the two products: in a beam search without the fused attention these
    are the values of the JAX package's operand-layout step
    (``_cross_attn_step_operand``, which always rounds), whose (B, h, dh,
    S) layout is a choice about the TPU's dots."""
    B, S, D = ck.shape
    K = x.shape[0] // B
    dh = D // heads
    q = linear(p.wq, x).reshape(B, K, heads, dh)
    scores = torch.einsum("bkhd,bshd->bkhs", _operand(q, ck.dtype, attn_f32),
                          ck.float().reshape(B, S, heads, dh)) / math.sqrt(dh)
    if encoder_mask is not None:
        scores = torch.where(encoder_mask[:, None, None, :] > 0, scores,
                             torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)  # (B, K, h, S)
    ctx = torch.einsum("bkhs,bshd->bkhd", _operand(w, cv.dtype, attn_f32),
                       cv.float().reshape(B, S, heads, dh)).to(x.dtype)
    return linear(p.wo, ctx.reshape(B * K, D)), w.mean(dim=2).reshape(B * K, S).to(x.dtype)


def _cross_attn_step_fused(p: Attention, x: Tensor, ck: Tensor, cv: Tensor,
                           encoder_mask: Optional[Tensor], heads: int,
                           num_beams: int) -> Tuple[Tensor, Tensor]:
    """The same through the ``beam_cross_attention`` kernel (the context and
    weights in the query's dtype, as the JAX kernel's outputs)."""
    mask = None if encoder_mask is None else encoder_mask.float().contiguous()
    ctx, w = beam_cross_attention(linear(p.wq, x).contiguous(), ck, cv, mask, heads, num_beams)
    return linear(p.wo, ctx), w


def _embed(dec: TransformerDecoder, token_ids: Tensor, t: int, dtype: torch.dtype) -> Tensor:
    # The JAX package's dynamic_slice clamps t to the table's last row.
    pos = dec.pos_embedding[min(t, dec.pos_embedding.shape[0] - 1)]
    return dec.embedding(token_ids).to(dtype) + pos.to(dtype)


def _decoder_blocks(dec: TransformerDecoder, config: Config, x: Tensor, state: Dict, t: int,
                    cross_kv: Dict[str, List[Tensor]], encoder_mask: Optional[Tensor],
                    qkv: MergedQKV, anc: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """The decoder blocks and final layer norm for one step; with ``anc``
    (lazy-rebeam beam search) the self-attention selects each beam's rows,
    and the kernel flags route the attention through ``ops/transformer_attn.py``
    as ``decode_step_beam_core`` does in the JAX package."""
    heads = config.model.transformer_num_heads
    k = config.kernels
    # Context parallelism keeps the plain attention (its collectives lie
    # outside the kernels), as in the JAX package.
    cp_axis = config.parallel.context_axis
    fused_self = anc is not None and k.transformer_fused_beam_attn and cp_axis is None
    # A JAX beam step without the fused beam attention reads bfloat16 cross
    # keys and values in its operand layout: its plain step, which rounds
    # the query and the weights whatever transformer_attn_dots_f32 says,
    # runs there even under kernels.transformer_fused_cross_attn.
    operand = (k.transformer_cross_kv_bf16 and not fused_self
               and x.shape[0] != cross_kv["k"][0].shape[0])
    fused_cross = anc is not None and cp_axis is None and not operand and (
        k.transformer_fused_beam_attn or k.transformer_fused_cross_attn)
    attn_f32 = k.transformer_attn_dots_f32
    cross_w = None
    for i, blk in enumerate(dec.blocks):
        wqkv = None if qkv is None else qkv[i]
        h_in, kc, vc = layer_norm(blk.ln1, x), state["k"][i], state["v"][i]
        if fused_self:
            h = _cached_self_attn_beam_fused(blk.self_attn, h_in, kc, vc, anc, t, heads,
                                             anc.shape[1], wqkv)
        elif anc is not None:
            h = _cached_self_attn_beam(blk.self_attn, h_in, kc, vc, anc, t, heads, wqkv,
                                       attn_f32)
        else:
            h = _cached_self_attn(blk.self_attn, h_in, kc, vc, t, heads, wqkv, attn_f32)
        x = x + h
        cross_args = (blk.cross_attn, layer_norm(blk.ln2, x), cross_kv["k"][i], cross_kv["v"][i],
                      encoder_mask, heads)
        if cp_axis is not None:
            h, cross_w = cross_attention_step_cp(*cross_args, cp_axis)
        elif fused_cross:
            h, cross_w = _cross_attn_step_fused(*cross_args, anc.shape[1])
        else:
            h, cross_w = _cross_attn_step(*cross_args, attn_f32 and not operand)
        x = x + h
        x = x + blk.mlp(layer_norm(blk.ln3, x))
    return layer_norm(dec.ln_f, x), cross_w


def decode_step_core(dec: TransformerDecoder, config: Config, token_ids: Tensor,
                     state: Dict[str, List[Tensor]], t: int, cross_kv: Dict[str, List[Tensor]],
                     encoder_mask: Optional[Tensor], qkv: MergedQKV = None,
                     state_dtype: Optional[torch.dtype] = None) -> Tuple[Tensor, Dict, Tensor]:
    """One decode step up to the pre-vocab state: (x (N, D), state, last
    block's cross-attention weights (N, S)). Writes row t of the caches in
    place; equal to column t of ``apply_transformer_decoder``. The token
    and position embeddings enter in ``state_dtype`` (default: the cross
    keys' dtype, as in the JAX package when no dtype is passed)."""
    x = _embed(dec, token_ids, t, state_dtype or cross_kv["k"][0].dtype)
    x, cross_w = _decoder_blocks(dec, config, x, state, t, cross_kv, encoder_mask, qkv, None)
    return x, state, cross_w


def decode_step(dec: TransformerDecoder, config: Config, token_ids: Tensor,
                state: Dict[str, List[Tensor]], t: int, cross_kv: Dict[str, List[Tensor]],
                encoder_mask: Optional[Tensor], qkv: MergedQKV = None,
                state_dtype: Optional[torch.dtype] = None):
    """One decode step -> (logits (N, V), state, cross-attention weights)."""
    x, state, cross_w = decode_step_core(dec, config, token_ids, state, t, cross_kv,
                                         encoder_mask, qkv, state_dtype)
    return linear(dec.output_projection, x), state, cross_w


def decode_step_beam_core(dec: TransformerDecoder, config: Config, token_ids: Tensor,
                          state: Dict, t: int, cross_kv: Dict[str, List[Tensor]],
                          encoder_mask: Optional[Tensor], qkv: MergedQKV = None,
                          state_dtype: Optional[torch.dtype] = None
                          ) -> Tuple[Tensor, Dict, Tensor]:
    """Beam step with lazy rebeam, state {"k", "v", "anc"}: sets column t of
    the ancestry to the identity (the rows written now lie in the writer's
    own slot), then attends through it. ``state_dtype`` as in
    ``decode_step_core``."""
    anc = state["anc"]
    anc[:, :, t] = torch.arange(anc.shape[1], dtype=anc.dtype, device=anc.device)
    x = _embed(dec, token_ids, t, state_dtype or cross_kv["k"][0].dtype)
    x, cross_w = _decoder_blocks(dec, config, x, state, t, cross_kv, encoder_mask, qkv, anc)
    return x, state, cross_w


def decode_step_beam(dec: TransformerDecoder, config: Config, token_ids: Tensor, state: Dict,
                     t: int, cross_kv: Dict[str, List[Tensor]],
                     encoder_mask: Optional[Tensor], qkv: MergedQKV = None,
                     state_dtype: Optional[torch.dtype] = None):
    """Lazy-rebeam beam step -> (logits (B*K, V), state, cross-attention
    weights (B*K, S))."""
    x, state, cross_w = decode_step_beam_core(dec, config, token_ids, state, t, cross_kv,
                                              encoder_mask, qkv, state_dtype)
    return linear(dec.output_projection, x), state, cross_w
