"""Bahdanau (additive) attention.

Counterpart of video_captioning_tpu/models/attention.py for the Bahdanau
type: ``precompute`` projects the encoder outputs once per sequence,
``attend`` runs one decode step for (B, D) queries and ``attend_beam`` for
(B, K, D) queries against the same un-expanded (B, S, .) tensors (the
cache is shared by the K beams, never copied K times). Masked frames get
the additive -1e9 fill before the softmax. In training, ``attend`` applies
dropout (rate ``ATTN_DROPOUT``, the JAX package's ``_ATTN_DROPOUT``) to the
weights before the context sum; the multiplier can be drawn by the caller
(``weight_scale``) so that a recomputed step sees the same mask. With
``kernels.use_pallas_attention`` set and ``train`` false, ``attend`` runs
the fused step of ``ops/attention.py`` (the kernel on CUDA tensors), as the
JAX package routes it to ``bahdanau_attend_pallas``; ``attend_beam`` has
no kernel in either package. Luong and multi-head attention are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.attention import bahdanau_attend
from .layers import dropout_mask

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


def precompute(attn: BahdanauAttention, encoder_outputs: Tensor) -> Dict[str, Tensor]:
    """Step-invariant projection of the encoder outputs: enc_proj (B, S, A)."""
    return {"enc_proj": attn.encoder_projection(encoder_outputs)}


def _softmax_context(scores: Tensor, encoder_outputs: Tensor,
                     encoder_mask: Optional[Tensor], mask_shape,
                     weight_scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    if encoder_mask is not None:
        scores = torch.where(encoder_mask.reshape(mask_shape) > 0, scores,
                             torch.full_like(scores, MASK_FILL))
    weights = torch.softmax(scores, dim=-1)
    if weight_scale is not None:  # dropout on the weights
        weights = weights * weight_scale.reshape(weights.shape).to(weights.dtype)
    return weights @ encoder_outputs, weights


def attend(
    config: Config,
    attn: BahdanauAttention,
    cache: Dict[str, Tensor],
    encoder_outputs: Tensor,   # (B, S, E)
    decoder_hidden: Tensor,    # (B, D)
    encoder_mask: Optional[Tensor],  # (B, S)
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    weight_scale: Optional[Tensor] = None,  # (B, S) dropout multiplier
) -> Tuple[Tensor, Tensor]:
    """Returns context (B, E) and weights (B, S), the weights after
    dropout in training. ``weight_scale`` is a multiplier drawn by the
    caller (``layers.dropout_mask``); otherwise one is drawn from
    ``generator`` when ``train``."""
    if config.kernels.use_pallas_attention and not train:
        lin = attn.attention_linear
        return bahdanau_attend(
            decoder_hidden.contiguous(), attn.decoder_projection.weight,
            attn.decoder_projection.bias, cache["enc_proj"], encoder_outputs,
            lin.weight[0], lin.bias,
            None if encoder_mask is None else encoder_mask.to(torch.float32).contiguous())
    dec_proj = attn.decoder_projection(decoder_hidden)  # (B, A)
    combined = torch.tanh(cache["enc_proj"] + dec_proj[:, None, :])  # (B, S, A)
    scores = attn.attention_linear(combined)[..., 0]  # (B, S)
    B, S = scores.shape
    if train and weight_scale is None:
        weight_scale = dropout_mask((B, S), ATTN_DROPOUT, generator, scores.device)
    ctx, w = _softmax_context(scores[:, None, :], encoder_outputs, encoder_mask, (B, 1, S),
                              weight_scale)
    return ctx[:, 0], w[:, 0]


def attend_beam(
    attn: BahdanauAttention,
    cache: Dict[str, Tensor],
    encoder_outputs: Tensor,   # (B, S, E), not beam-expanded
    decoder_hidden: Tensor,    # (B, K, D)
    encoder_mask: Optional[Tensor],  # (B, S)
) -> Tuple[Tensor, Tensor]:
    """Returns context (B, K, E) and weights (B, K, S)."""
    dec_proj = attn.decoder_projection(decoder_hidden)  # (B, K, A)
    combined = torch.tanh(cache["enc_proj"][:, None, :, :] + dec_proj[:, :, None, :])
    scores = attn.attention_linear(combined)[..., 0]  # (B, K, S)
    B, _, S = scores.shape
    return _softmax_context(scores, encoder_outputs, encoder_mask, (B, 1, S))
