"""Decode-loop adapters for the two model families.

Counterpart of video_captioning_tpu/generation/families.py: per family,
the initial state for B*K rows, the greedy and beam steps (the beam step
also stopped at the pre-vocab state, for the fused vocabulary kernel) and
the rebeam. Every step takes the position t, which the transformer's
caches and position table need.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..config import Config

from ..models import decoder as decoder_mod
from ..models import transformer as tr
from ..models.captioner import VideoCaptioningModel, is_transformer
from ..models.layers import Int8Linear

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


def vocab_projection_info(dec: torch.nn.Module) -> Tuple[int, bool]:
    """(V, whether it is in W8A8 form) of a decoder's vocabulary
    projection, read from whichever form it holds (the JAX package keys on
    ``"kernel"`` / ``"kernel_q"``)."""
    proj = dec.output_projection
    return getattr(proj, "full_out_features", proj.out_features), isinstance(proj, Int8Linear)


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


def float32_copy(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with every bfloat16 parameter and buffer widened to
    float32 (exactly), the others shared: a copy of the module tree whose
    tensors are the casts, as the JAX package's ``tree_map`` of
    ``astype(float32)`` over the parameters. The casts are ordinary ops, so
    a traced program (``torch.export``) repeats them each call, as the JAX
    program does."""
    new = copy.copy(module)

    def widen(x):
        return x.float() if x is not None and x.dtype == torch.bfloat16 else x

    new._parameters = {k: widen(p) for k, p in module._parameters.items()}
    new._buffers = {k: widen(b) for k, b in module._buffers.items()}
    new._modules = {k: None if m is None else float32_copy(m) for k, m in module._modules.items()}
    return new


def _transformer_family(model, config, encoder_outputs, encoder_mask, K,
                        max_length) -> DecodeFamily:
    """KV-cache decoding under the JAX package's dtype policy
    (``generation/families.py:_transformer_family``):

    * ``transformer_beam_params_f32`` (beam, bfloat16 parameters, unless
      ``transformer_bf16_beam_state``): the decoder's parameters widened to
      float32 once a call (``float32_copy``);
    * the residual stream and caches (``state_dtype``) in the encoder
      outputs' dtype, except the float32-state hybrid: a beam search over
      bfloat16 encoder outputs without the fused beam attention and without
      ``transformer_bf16_beam_state`` runs a float32 state and widens the
      cross keys and values;
    * ``transformer_cross_kv_bf16``: the cross keys and values stored in
      bfloat16 in every arm (the greedy step, the plain beam step, whose
      JAX operand layout only orders the same values for the TPU, and the
      fused ``beam_cross_attention``);
    * greedy keeps bfloat16 parameters and state.

    ``transformer_attn_dots_f32`` is read by the decode steps
    (``models/transformer.py:_operand``). ``transformer_decode_weights_bf16``
    is gated to the TPU in the JAX package and has no counterpart;
    ``transformer_select_gather`` selects the same values as the one-hot
    product it replaces."""
    dec = model.decoder
    kc = config.kernels
    B = encoder_outputs.shape[0]
    dev = encoder_outputs.device
    fused_attn = (kc.transformer_fused_beam_attn and kc.transformer_lazy_rebeam
                  and config.parallel.context_axis is None)
    proj_weight = getattr(dec.output_projection, "weight", None)
    if (K > 1 and kc.transformer_beam_params_f32 and not kc.transformer_bf16_beam_state
            and proj_weight is not None and proj_weight.dtype == torch.bfloat16):
        dec = float32_copy(dec)
    # Beam search only, as in the JAX package.
    qkv = tr.merge_self_attn_qkv(dec) if kc.transformer_merge_qkv and K > 1 else None
    cross_kv = tr.precompute_cross_kv(dec, encoder_outputs)
    state_dtype = encoder_outputs.dtype
    if (K > 1 and state_dtype == torch.bfloat16 and not fused_attn
            and not kc.transformer_bf16_beam_state):
        state_dtype = torch.float32
        cross_kv = {name: [c.float() for c in cs] for name, cs in cross_kv.items()}
    if kc.transformer_cross_kv_bf16:
        cross_kv = {name: [c.to(torch.bfloat16) for c in cs] for name, cs in cross_kv.items()}
    cache_dtype = torch.bfloat16 if kc.transformer_cache_bf16 else None
    state0 = tr.init_decode_state(dec, config, B * K, state_dtype, dev,
                                  max_positions=max_length, cache_dtype=cache_dtype)
    # Lazy rebeam: the caches stay physical-slot indexed and the rebeam
    # composes only the (B, K, T) ancestry. At K = 1, or with the flag off,
    # the caches themselves are gathered.
    lazy = K > 1 and kc.transformer_lazy_rebeam
    if lazy:
        state0["anc"] = tr.init_beam_ancestry(B, K, state0["k"][0].shape[0], dev)

    def step(tokens, state, t):
        return tr.decode_step(dec, config, tokens, state, t, cross_kv, encoder_mask, qkv,
                              state_dtype)

    def step_beam(tokens_bk, state, t):
        fn = tr.decode_step_beam if lazy else tr.decode_step
        return fn(dec, config, tokens_bk.reshape(-1), state, t, cross_kv, encoder_mask, qkv,
                  state_dtype)

    def step_beam_core(tokens_bk, state, t):
        fn = tr.decode_step_beam_core if lazy else tr.decode_step_core
        return fn(dec, config, tokens_bk.reshape(-1), state, t, cross_kv, encoder_mask, qkv,
                  state_dtype)

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
