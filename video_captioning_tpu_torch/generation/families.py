"""Decode-loop adapter for the LSTM family.

Counterpart of video_captioning_tpu/generation/families.py (_lstm_family):
the initial state for B*K rows, the greedy and beam steps over the shared
attention cache, and the rebeam of the (h, c) state. The transformer
family is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import Config

from ..models import attention as attn_mod
from ..models import decoder as decoder_mod
from ..models.captioner import VideoCaptioningModel

Tensor = torch.Tensor


class DecodeFamily(NamedTuple):
    """state0: decode state for B*K rows.
    step:      (tokens (N,), state) -> (logits (N, V), state, weights (N, S))
    step_beam: (tokens (B, K), state) -> (logits (B*K, V), state, weights)
    rebeam:    (state, beam_idx (B, K) old-beam index per new beam) -> state
    """

    state0: decoder_mod.State
    step: Callable
    step_beam: Callable
    rebeam: Callable


def make_decode_family(
    model: VideoCaptioningModel,
    config: Config,
    encoder_outputs: Tensor,
    encoder_final_state: Tensor,
    encoder_mask: Optional[Tensor],
    num_beams: int = 1,
) -> DecodeFamily:
    dec = model.decoder
    attn_cache = attn_mod.precompute(dec.attention, encoder_outputs)
    enc_final = encoder_final_state.repeat_interleave(num_beams, dim=0)
    state0 = decoder_mod.init_hidden_state(dec, config, enc_final)

    def step(tokens, state):
        return decoder_mod.decoder_step(
            dec, tokens, state, encoder_outputs, attn_cache, encoder_mask)

    def step_beam(tokens_bk, state):
        return decoder_mod.decoder_step_beam(
            dec, tokens_bk, state, encoder_outputs, attn_cache, encoder_mask)

    def rebeam(state, beam_idx):
        # Selects whole rows, so the values are exactly the JAX package's
        # one-hot contraction (x * 1 + 0 * others).
        B, K = beam_idx.shape

        def rb(x):
            L, _, H = x.shape
            idx = beam_idx[None, :, :, None].expand(L, B, K, H)
            return torch.gather(x.reshape(L, B, K, H), 2, idx).reshape(L, B * K, H)

        return rb(state[0]), rb(state[1])

    return DecodeFamily(state0, step, step_beam, rebeam)
