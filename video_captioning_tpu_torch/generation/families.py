"""Decode-loop adapters for the two model families.

Counterpart of video_captioning_tpu/generation/families.py: per family,
the initial state for B*K rows, the greedy and beam steps (the beam step
also stopped at the pre-vocab state, for the fused vocabulary kernel) and
the rebeam. Every step takes the position t, which the transformer's
caches and position table need.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..config import Config

from ..models import decoder as decoder_mod
from ..models import transformer as tr
from ..models.captioner import VideoCaptioningModel, is_transformer

Tensor = torch.Tensor


class DecodeFamily(NamedTuple):
    """state0: decode state for B*K rows.
    step:      (tokens (N,), state, t) -> (logits (N, V), state, weights (N, S))
    step_beam: (tokens (B, K), state, t) -> (logits (B*K, V), state, weights)
    step_beam_core: the same, stopped at the pre-vocab state (B*K, H)
    rebeam:    (state, beam_idx (B, K) old-beam index per new beam) -> state
    has_weights: whether the steps give attention weights (not so for an
               LSTM decoder without attention, whose steps give None)
    """

    state0: Any
    step: Callable
    step_beam: Callable
    step_beam_core: Callable
    rebeam: Callable
    has_weights: bool


def make_decode_family(
    model: VideoCaptioningModel,
    config: Config,
    encoder_outputs: Tensor,
    encoder_final_state: Tensor,
    encoder_mask: Optional[Tensor],
    num_beams: int = 1,
    max_length: int = 20,
) -> DecodeFamily:
    if is_transformer(config):
        return _transformer_family(model, config, encoder_outputs, encoder_mask, num_beams,
                                   max_length)
    return _lstm_family(model, config, encoder_outputs, encoder_final_state, encoder_mask,
                        num_beams)


def _lstm_family(model, config, encoder_outputs, encoder_final_state, encoder_mask,
                 num_beams) -> DecodeFamily:
    dec = model.decoder
    attn_cache = decoder_mod.precompute_attention(dec, encoder_outputs)
    enc_final = encoder_final_state.repeat_interleave(num_beams, dim=0)
    state0 = decoder_mod.init_hidden_state(dec, config, enc_final)

    def step(tokens, state, t):
        return decoder_mod.decoder_step(
            dec, config, tokens, state, encoder_outputs, attn_cache, encoder_mask)

    def step_beam(tokens_bk, state, t):
        return decoder_mod.decoder_step_beam(
            dec, config, tokens_bk, state, encoder_outputs, attn_cache, encoder_mask)

    def step_beam_core(tokens_bk, state, t):
        return decoder_mod.decoder_step_beam_core(
            dec, config, tokens_bk, state, encoder_outputs, attn_cache, encoder_mask)

    def rebeam(state, beam_idx):
        # Selects whole rows, so the values are exactly the JAX package's
        # one-hot contraction (x * 1 + 0 * others).
        B, K = beam_idx.shape

        def rb(x):
            L, _, H = x.shape
            idx = beam_idx[None, :, :, None].expand(L, B, K, H)
            return torch.gather(x.reshape(L, B, K, H), 2, idx).reshape(L, B * K, H)

        return rb(state[0]), rb(state[1])

    return DecodeFamily(state0, step, step_beam, step_beam_core, rebeam, dec.use_attention)


def _transformer_family(model, config, encoder_outputs, encoder_mask, K,
                        max_length) -> DecodeFamily:
    """KV-cache decoding. The JAX package's other transformer options need
    no counterpart here: ``transformer_beam_params_f32`` and
    ``transformer_bf16_beam_state`` act only on bfloat16 parameters, which
    the port does not serve for the transformer;
    ``transformer_decode_weights_bf16`` is gated to the TPU;
    ``transformer_attn_dots_f32`` and ``transformer_select_gather``
    give equal values in float32 (``transformer_cross_kv_bf16`` is refused
    by ``check_supported``)."""
    dec = model.decoder
    kc = config.kernels
    B = encoder_outputs.shape[0]
    dev = encoder_outputs.device
    # Beam search only, as in the JAX package.
    qkv = tr.merge_self_attn_qkv(dec) if kc.transformer_merge_qkv and K > 1 else None
    cross_kv = tr.precompute_cross_kv(dec, encoder_outputs)
    cache_dtype = torch.bfloat16 if kc.transformer_cache_bf16 else None
    state0 = tr.init_decode_state(dec, config, B * K, encoder_outputs.dtype, dev,
                                  max_positions=max_length, cache_dtype=cache_dtype)
    # Lazy rebeam: the caches stay physical-slot indexed and the rebeam
    # composes only the (B, K, T) ancestry. At K = 1, or with the flag off,
    # the caches themselves are gathered.
    lazy = K > 1 and kc.transformer_lazy_rebeam
    if lazy:
        state0["anc"] = tr.init_beam_ancestry(B, K, state0["k"][0].shape[0], dev)

    def step(tokens, state, t):
        return tr.decode_step(dec, config, tokens, state, t, cross_kv, encoder_mask, qkv)

    def step_beam(tokens_bk, state, t):
        fn = tr.decode_step_beam if lazy else tr.decode_step
        return fn(dec, config, tokens_bk.reshape(-1), state, t, cross_kv, encoder_mask, qkv)

    def step_beam_core(tokens_bk, state, t):
        fn = tr.decode_step_beam_core if lazy else tr.decode_step_core
        return fn(dec, config, tokens_bk.reshape(-1), state, t, cross_kv, encoder_mask, qkv)

    def rebeam(state, beam_idx):
        Bn, Kn = beam_idx.shape
        if lazy:
            # anc[b, n, :] = anc[b, beam_idx[b, n], :]: new beam n inherits old
            # beam k's slots; column t (the identity) composes to beam_idx.
            anc = state["anc"]
            idx = beam_idx[:, :, None].expand(Bn, Kn, anc.shape[2])
            return dict(state, anc=torch.gather(anc, 1, idx))
        # Physical rebeam: row b*K + n of every cache takes row
        # b*K + beam_idx[b, n], the step's own row t included.
        rows = (torch.arange(Bn, device=beam_idx.device)[:, None] * Kn + beam_idx).reshape(-1)
        return {name: [c.index_select(1, rows) for c in state[name]] for name in ("k", "v")}

    return DecodeFamily(state0, step, step_beam, step_beam_core, rebeam, True)
