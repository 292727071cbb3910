"""Attention over the encoder outputs: Bahdanau, Luong (dot / general /
concat) and multi-head.

Counterpart of video_captioning_tpu/models/attention.py. The module holds
the parameters of ``config.model.attention_type`` (``make_attention``),
under the upstream names that ``cli.import_reference`` reads;
``precompute`` projects the encoder outputs once per sequence (Bahdanau's
and Luong-concat's ``enc_proj``, multi-head's keys and values),
``attend`` runs one decode step for (B, D) queries and ``attend_beam`` for
(B, K, D) queries against the same un-expanded (B, S, .) tensors (the
cache is shared by the K beams, never copied K times). The functions
dispatch on the module's type, which ``make_attention`` picked from the
config. Masked frames get the -1e9 fill before the softmax. Multi-head
scores and softmax run in float32 whatever the parameters' dtype, the
context is cast back to the hidden dtype, and the weights returned are the
heads' mean.

In training, ``attend`` applies dropout (rate ``ATTN_DROPOUT``, the JAX
package's ``_ATTN_DROPOUT``) to the weights before the context sum: the
(B, S) weights of Bahdanau and Luong, the (B, H, S) weights of multi-head
(``dropout_shape``). The multiplier can be drawn by the caller
(``weight_scale``) so that a recomputed step sees the same mask.

Kernel flags: with ``kernels.use_pallas_attention`` set and ``train``
false, a Bahdanau ``attend`` runs the fused step of ``ops/attention.py``
(the kernel on CUDA tensors), as the JAX package routes only Bahdanau to
``bahdanau_attend_pallas``; Luong and multi-head never reach it.
``kernels.attention_score_bf16`` takes Bahdanau's tanh in bfloat16 with
the score reduction accumulated in float32, in ``attend`` and
``attend_beam``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.attention import bahdanau_attend
from .layers import bf16_products_f32, dropout_mask, linear

Tensor = torch.Tensor

MASK_FILL = -1e9
ATTN_DROPOUT = 0.1  # reference attention.py:30,101,218


class BahdanauAttention(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        E, D, A = m.encoder_hidden_dim, m.decoder_hidden_dim, m.attention_dim
        self.encoder_projection = nn.Linear(E, A)
        self.decoder_projection = nn.Linear(D, A)
        self.attention_linear = nn.Linear(A, 1)


class LuongAttention(nn.Module):
    """``score``: "general" (``linear_in``, no bias), "concat"
    (``linear_query``, ``linear_context``, ``linear_v`` without bias) or
    "dot" (no parameters; decoder and encoder widths must agree)."""

    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        E, D, A = m.encoder_hidden_dim, m.decoder_hidden_dim, m.attention_dim
        self.score = m.luong_score
        if self.score == "general":
            self.linear_in = nn.Linear(D, E, bias=False)
        elif self.score == "concat":
            self.linear_query = nn.Linear(D, A)
            self.linear_context = nn.Linear(E, A)
            self.linear_v = nn.Linear(A, 1, bias=False)
        elif self.score == "dot":
            if D != E:
                raise ValueError("dot attention requires decoder_dim == encoder_dim")
        else:
            raise ValueError(f"Unknown luong_score: {self.score}")


class MultiheadAttention(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        E, D = m.encoder_hidden_dim, m.decoder_hidden_dim
        self.num_heads = m.attention_num_heads
        if E % self.num_heads != 0:
            raise ValueError("encoder_dim must be divisible by num_heads")
        self.query_linear = nn.Linear(D, E)
        self.key_linear = nn.Linear(E, E)
        self.value_linear = nn.Linear(E, E)
        self.output_linear = nn.Linear(E, E)


ATTENTION_TYPES = {"bahdanau": BahdanauAttention, "luong": LuongAttention,
                   "multihead": MultiheadAttention}


def make_attention(config: Config) -> nn.Module:
    kind = config.model.attention_type
    if kind not in ATTENTION_TYPES:
        raise ValueError(f"Unsupported attention type: {kind}")
    return ATTENTION_TYPES[kind](config)


def precompute(attn: nn.Module, encoder_outputs: Tensor) -> Dict[str, Tensor]:
    """Step-invariant projections of the encoder outputs: ``enc_proj``
    (B, S, A) for Bahdanau and Luong-concat, ``k`` and ``v`` (B, S, H, hd)
    for multi-head, nothing for Luong dot and general."""
    if isinstance(attn, BahdanauAttention):
        return {"enc_proj": linear(attn.encoder_projection, encoder_outputs)}
    if isinstance(attn, LuongAttention):
        if attn.score == "concat":
            return {"enc_proj": linear(attn.linear_context, encoder_outputs)}
        return {}
    B, S, E = encoder_outputs.shape
    heads = (B, S, attn.num_heads, E // attn.num_heads)
    return {"k": linear(attn.key_linear, encoder_outputs).reshape(heads),
            "v": linear(attn.value_linear, encoder_outputs).reshape(heads)}


def dropout_shape(attn: nn.Module, B: int, S: int) -> Tuple[int, ...]:
    """The shape of the weights that attention dropout acts on."""
    return (B, attn.num_heads, S) if isinstance(attn, MultiheadAttention) else (B, S)


def _bahdanau_scores(config: Config, attn: BahdanauAttention, enc_proj: Tensor,
                     dec_proj: Tensor) -> Tensor:
    """Scores from enc_proj (B, 1, S, A) or (B, S, A) and dec_proj
    broadcast against it; the trailing A axis is reduced."""
    lin = attn.attention_linear
    if not config.kernels.attention_score_bf16:
        return linear(lin, torch.tanh(enc_proj + dec_proj))[..., 0]
    combined = torch.tanh(enc_proj.to(torch.bfloat16) + dec_proj.to(torch.bfloat16))
    scores = bf16_products_f32(combined, lin.weight.to(torch.bfloat16))[..., 0]
    return (scores + lin.bias).to(enc_proj.dtype)


def _luong_scores(attn: LuongAttention, cache: Dict[str, Tensor], enc_outs: Tensor,
                  dec_hidden: Tensor) -> Tensor:
    """dec_hidden (B, Q, D) -> scores (B, Q, S)."""
    if attn.score == "dot":
        return dec_hidden @ enc_outs.transpose(1, 2)
    if attn.score == "general":
        return linear(attn.linear_in, dec_hidden) @ enc_outs.transpose(1, 2)
    dec_proj = linear(attn.linear_query, dec_hidden)  # (B, Q, A)
    combined = torch.tanh(dec_proj[:, :, None, :] + cache["enc_proj"][:, None, :, :])
    return linear(attn.linear_v, combined)[..., 0]


def _multihead(attn: MultiheadAttention, cache: Dict[str, Tensor], dec_hidden: Tensor,
               encoder_mask: Optional[Tensor],
               weight_scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """dec_hidden (B, Q, D) -> context (B, Q, E), head-mean weights (B, Q, S)."""
    k, v = cache["k"], cache["v"]  # (B, S, H, hd)
    B, S, H, hd = k.shape
    Q = dec_hidden.shape[1]
    q = linear(attn.query_linear, dec_hidden).reshape(B, Q, H, hd)
    # Scores and softmax in float32 whatever the parameters' dtype (the JAX
    # package's float32 divisor promotes them); float32 inputs are unchanged.
    s = torch.einsum("bqhd,bshd->bqhs", q, k).float() / math.sqrt(hd)
    if encoder_mask is not None:
        s = torch.where(encoder_mask[:, None, None, :] > 0, s, torch.full_like(s, MASK_FILL))
    w = torch.softmax(s, dim=-1)  # (B, Q, H, S)
    if weight_scale is not None:
        w = w * weight_scale.reshape(w.shape).to(w.dtype)
    ctx = torch.einsum("bqhs,bshd->bqhd", w.to(v.dtype), v).reshape(B, Q, H * hd)
    ctx = linear(attn.output_linear, ctx)
    out_dtype = dec_hidden.dtype
    return ctx.to(out_dtype), w.mean(dim=2).to(out_dtype)


def _softmax_context(scores: Tensor, encoder_outputs: Tensor,
                     encoder_mask: Optional[Tensor],
                     weight_scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """scores (B, Q, S) -> context (B, Q, E) and weights (B, Q, S)."""
    if encoder_mask is not None:
        scores = torch.where(encoder_mask[:, None, :] > 0, scores,
                             torch.full_like(scores, MASK_FILL))
    weights = torch.softmax(scores, dim=-1)
    if weight_scale is not None:  # dropout on the weights
        weights = weights * weight_scale.reshape(weights.shape).to(weights.dtype)
    return weights @ encoder_outputs, weights


def _attend_queries(config: Config, attn: nn.Module, cache: Dict[str, Tensor],
                    encoder_outputs: Tensor, queries: Tensor,
                    encoder_mask: Optional[Tensor],
                    weight_scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """queries (B, Q, D) -> context (B, Q, E) and weights (B, Q, S)."""
    if isinstance(attn, MultiheadAttention):
        return _multihead(attn, cache, queries, encoder_mask, weight_scale)
    if isinstance(attn, BahdanauAttention):
        dec_proj = linear(attn.decoder_projection, queries)  # (B, Q, A)
        scores = _bahdanau_scores(config, attn, cache["enc_proj"][:, None, :, :],
                                  dec_proj[:, :, None, :])
    else:
        scores = _luong_scores(attn, cache, encoder_outputs, queries)
    return _softmax_context(scores, encoder_outputs, encoder_mask, weight_scale)


def attend(
    config: Config,
    attn: nn.Module,
    cache: Dict[str, Tensor],
    encoder_outputs: Tensor,   # (B, S, E)
    decoder_hidden: Tensor,    # (B, D)
    encoder_mask: Optional[Tensor],  # (B, S)
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    weight_scale: Optional[Tensor] = None,  # dropout multiplier, dropout_shape
) -> Tuple[Tensor, Tensor]:
    """Returns context (B, E) and weights (B, S), the weights after
    dropout in training (multi-head: the heads' mean of them).
    ``weight_scale`` is a multiplier drawn by the caller
    (``layers.dropout_mask``); otherwise one is drawn from ``generator``
    when ``train``."""
    if (isinstance(attn, BahdanauAttention) and config.kernels.use_pallas_attention
            and not train):
        lin = attn.attention_linear
        return bahdanau_attend(
            decoder_hidden.contiguous(), attn.decoder_projection.weight,
            attn.decoder_projection.bias, cache["enc_proj"], encoder_outputs,
            lin.weight[0], lin.bias,
            None if encoder_mask is None else encoder_mask.to(torch.float32).contiguous())
    if train and weight_scale is None:
        shape = dropout_shape(attn, *encoder_outputs.shape[:2])
        weight_scale = dropout_mask(shape, ATTN_DROPOUT, generator, encoder_outputs.device)
    ctx, w = _attend_queries(config, attn, cache, encoder_outputs, decoder_hidden[:, None],
                             encoder_mask, weight_scale)
    return ctx[:, 0], w[:, 0]


def attend_beam(
    config: Config,
    attn: nn.Module,
    cache: Dict[str, Tensor],
    encoder_outputs: Tensor,   # (B, S, E), not beam-expanded
    decoder_hidden: Tensor,    # (B, K, D)
    encoder_mask: Optional[Tensor],  # (B, S)
) -> Tuple[Tensor, Tensor]:
    """Returns context (B, K, E) and weights (B, K, S); eval only."""
    return _attend_queries(config, attn, cache, encoder_outputs, decoder_hidden, encoder_mask)
