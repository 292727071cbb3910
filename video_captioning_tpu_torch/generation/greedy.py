"""Greedy decoding on the device, without a host sync per step.

Counterpart of video_captioning_tpu/generation/greedy.py. The JAX loop
stops once every row has emitted END (or at max_length). Here the loop
runs max_length steps and a step taken after that point changes nothing:
the carry is frozen with ``torch.where(active, new, old)``, so the result
is the JAX loop's, including PAD (0) in the positions it never reached.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config

from ..models.captioner import VideoCaptioningModel
from .families import make_decode_family

Tensor = torch.Tensor


def greedy_generate(
    model: VideoCaptioningModel,
    config: Config,
    encoder_outputs: Tensor,
    encoder_final_state: Tensor,
    start_token_id: int,
    end_token_id: int,
    max_length: int = 20,
    encoder_mask: Optional[Tensor] = None,
    temperature: float = 1.0,
) -> Dict[str, Tensor]:
    """Returns ``generated_tokens`` (B, max_length) and
    ``attention_weights`` (B, max_length, S)."""
    B, S, _ = encoder_outputs.shape
    dev = encoder_outputs.device
    family = make_decode_family(model, config, encoder_outputs, encoder_final_state,
                                encoder_mask, num_beams=1)
    state = family.state0
    tokens = torch.zeros((B, max_length), dtype=torch.int64, device=dev)
    weights = torch.zeros((B, max_length, S), dtype=encoder_outputs.dtype, device=dev)
    input_tok = torch.full((B,), start_token_id, dtype=torch.int64, device=dev)
    ended = torch.zeros((B,), dtype=torch.bool, device=dev)

    for t in range(max_length):
        active = ~ended.all()
        logits, new_state, w = family.step(input_tok, state)
        if temperature != 1.0:
            logits = logits / temperature
        next_tok = torch.argmax(logits, dim=-1)
        tokens[:, t] = torch.where(active, next_tok, tokens[:, t])
        weights[:, t] = torch.where(active, w, weights[:, t])
        state = tuple(torch.where(active, n, o) for n, o in zip(new_state, state))
        ended = torch.where(active, ended | (next_tok == end_token_id), ended)
        input_tok = torch.where(active, next_tok, input_tok)

    return {"generated_tokens": tokens.to(torch.int32), "attention_weights": weights}
