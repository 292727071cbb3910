"""Ancestral sampling on the device (temperature / top-k), without a host
sync per step.

Counterpart of video_captioning_tpu/generation/sampling.py: per step,
logits / max(T, 1e-6), optionally every logit below the k-th largest set
to -inf, then a categorical draw. The draw is ``argmax(logits + g)`` with
Gumbel noise g, which is what ``jax.random.categorical`` computes; g comes
from the caller's ``torch.Generator`` on the tensors' device
(:func:`gumbel_noise`), or, for a draw that must equal another one, from
``noise``: one (B, V) tensor per step. A row that has ended emits PAD (0),
stops adding to its log-probability and is fed END. The JAX loop stops
once every row has ended (or at max_length); here the loop runs
max_length steps and freezes its outputs with ``torch.where(active, new,
old)`` from that point, so they are the JAX loop's (see
generation/greedy.py). A step after the stop still draws its noise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..config import Config

from ..models.captioner import VideoCaptioningModel
from .families import make_decode_family

Tensor = torch.Tensor


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device: torch.device) -> Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sample_generate(
    model: VideoCaptioningModel,
    config: Config,
    encoder_outputs: Tensor,
    encoder_final_state: Tensor,
    start_token_id: int,
    end_token_id: int,
    max_length: int = 20,
    encoder_mask: Optional[Tensor] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[Tensor]] = None,
    batch_active: Optional[Callable[[Tensor], Tensor]] = None,
) -> Dict[str, Tensor]:
    """Returns ``generated_tokens`` (B, max_length) and per-clip
    ``logprobs`` (B,) summed over the sampled tokens up to END.
    ``batch_active``: as in ``greedy_generate``."""
    B = encoder_outputs.shape[0]
    dev = encoder_outputs.device
    family = make_decode_family(model, config, encoder_outputs, encoder_final_state,
                                encoder_mask, num_beams=1, max_length=max_length)
    state = family.state0
    tokens = torch.zeros((B, max_length), dtype=torch.int64, device=dev)
    input_tok = torch.full((B,), start_token_id, dtype=torch.int64, device=dev)
    ended = torch.zeros((B,), dtype=torch.bool, device=dev)
    logprob = torch.zeros((B,), dtype=torch.float32, device=dev)

    for t in range(max_length):
        active = ~ended.all()
        if batch_active is not None:
            active = batch_active(active)
        logits, state, _ = family.step(input_tok, state, t)
        logits = logits.float() / max(temperature, 1e-6)
        if top_k and top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits >= kth, logits, torch.full_like(logits, -torch.inf))
        g = (gumbel_noise(logits.shape, generator, dev) if noise is None
             else noise[t].to(device=dev, dtype=torch.float32))
        next_tok = torch.argmax(logits + g, dim=-1)
        tok_logp = torch.log_softmax(logits, dim=-1).gather(1, next_tok[:, None])[:, 0]

        next_tok = torch.where(ended, 0, next_tok)
        new_logprob = logprob + torch.where(ended, 0.0, tok_logp)
        new_ended = ended | (next_tok == end_token_id)
        feed = torch.where(new_ended & (next_tok == 0), end_token_id, next_tok)
        tokens[:, t] = torch.where(active, next_tok, tokens[:, t])
        logprob = torch.where(active, new_logprob, logprob)
        ended = torch.where(active, new_ended, ended)
        input_tok = torch.where(active, feed, input_tok)

    return {"generated_tokens": tokens.to(torch.int32), "logprobs": logprob}
