"""Attention LSTM caption decoder, one decode step at a time.

Counterpart of video_captioning_tpu/models/decoder.py (init_hidden_state,
decoder_core_step, decoder_step, decoder_step_beam(_core)): embedding ->
attention of ``config.model.attention_type`` (Bahdanau, Luong or
multi-head, ``models/attention.py``) over the encoder outputs with the
previous top-layer h -> LSTM stack on [embedding ; context] -> deep output
tanh(W [lstm_top ; context ; embedding]) -> vocabulary projection. With
``model.use_attention`` off the decoder has no attention and no deep
output: the LSTM stack takes the embedding alone, its top h is the
pre-vocab state, and the steps return no weights (``None``). The state is
(h, c), each (L, N, H).

``apply_decoder`` is teacher forcing for training, with the JAX package's
hoists: the embeddings and their slice of layer 1's input projection for
all steps at once, and the deep-output head and vocabulary projection over
the stacked (B*T, .) states. Dropout (on the embeddings, between LSTM
layers, and on the attention weights) runs with ``train=True`` and a
generator.

The decode steps take the ``Config`` as the JAX functions do: with
``kernels.use_pallas_lstm`` every decoder cell runs the fused cell of
``ops/lstm_cell.py`` whatever the attention type, and with
``kernels.use_pallas_attention`` a Bahdanau greedy step's and eval-mode
teacher forcing's attention runs ``ops/attention.py`` (each the kernel on
CUDA tensors, its plain version on the CPU). Teacher forcing's own LSTM
layers stay unfused, as in the JAX package.
``training.remat_attention`` recomputes each step's attention in the
backward pass (``torch.utils.checkpoint``); the dropout multiplier of the
weights is drawn outside the recomputed function for every attention type,
so values and gradients are the same either way.

Linears and cells follow ``layers.linear``'s dtype rule, so a decoder
with bfloat16 parameters keeps float32 activations as the JAX package's
does (the embeddings are bfloat16, as the table is).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config

from ..ops.lstm_cell import lstm_cell_fused
from .attention import ATTN_DROPOUT, attend, attend_beam, dropout_shape, make_attention, precompute
from .layers import LSTMWeights, dropout, dropout_mask, gates_tail, linear, lstm_cell

Tensor = torch.Tensor
State = Tuple[Tensor, Tensor]


class Decoder(nn.Module):
    def __init__(self, config: Config, vocab_size: int):
        super().__init__()
        m = config.model
        emb, H, E = m.embedding_dim, m.decoder_hidden_dim, m.encoder_hidden_dim
        self.use_attention = m.use_attention
        self.embedding = nn.Embedding(vocab_size, emb)
        self.lstm = LSTMWeights(emb + E if m.use_attention else emb, H, m.decoder_num_layers)
        if m.use_attention:
            self.attention = make_attention(config)
            self.context_projection = nn.Linear(E + H + emb, H)
        self.output_projection = nn.Linear(H, vocab_size)
        if E != H:
            self.init_state_projection = nn.Linear(E, H)


def init_hidden_state(dec: Decoder, config: Config, encoder_final_state: Tensor) -> State:
    """The (projected) encoder final state in every layer; zero cell."""
    projected = encoder_final_state
    if hasattr(dec, "init_state_projection"):
        projected = linear(dec.init_state_projection, projected)
    h = projected[None].expand((config.model.decoder_num_layers,) + projected.shape)
    return h, torch.zeros_like(h)


def _lstm_stack_step(dec: Decoder, config: Config, x: Tensor,
                     state: State) -> Tuple[Tensor, State]:
    """One decode step through the LSTM layers (eval only: the port's
    decode steps take no dropout)."""
    h_prev, c_prev = state
    hs, cs = [], []
    inp = x
    for l in range(dec.lstm.num_layers):
        if config.kernels.use_pallas_lstm:
            h_new, c_new = lstm_cell_fused(dec.lstm.layer(l), inp.contiguous(),
                                           h_prev[l].contiguous(), c_prev[l].contiguous())
        else:
            h_new, c_new = lstm_cell(dec.lstm.layer(l), inp, h_prev[l], c_prev[l])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, (torch.stack(hs), torch.stack(cs))


def precompute_attention(dec: Decoder, encoder_outputs: Tensor) -> Dict[str, Tensor]:
    """The attention's step-invariant cache; empty without attention."""
    return precompute(dec.attention, encoder_outputs) if dec.use_attention else {}


def _deep_output(dec: Decoder, lstm_top: Tensor, context: Optional[Tensor],
                 embedded: Tensor) -> Tensor:
    """The pre-vocab state: tanh(W [lstm_top ; context ; embedding]), or
    lstm_top itself without attention."""
    if not dec.use_attention:
        return lstm_top
    return torch.tanh(linear(dec.context_projection,
                             torch.cat([lstm_top, context, embedded], dim=-1)))


def decoder_core_step(
    dec: Decoder,
    config: Config,
    embedded: Tensor,          # (B, emb)
    state: State,
    encoder_outputs: Tensor,   # (B, S, E)
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Optional[Tensor]]:
    """Returns the pre-vocab state (B, H), the new state and the weights
    (B, S), or None without attention."""
    context = weights = None
    lstm_in = embedded
    if dec.use_attention:
        context, weights = attend(config, dec.attention, attn_cache, encoder_outputs,
                                  state[0][-1], encoder_mask)
        lstm_in = torch.cat([embedded, context], dim=-1)
    lstm_top, new_state = _lstm_stack_step(dec, config, lstm_in, state)
    return _deep_output(dec, lstm_top, context, embedded), new_state, weights


def decoder_step(
    dec: Decoder,
    config: Config,
    input_token: Tensor,       # (B,) token ids
    state: State,
    encoder_outputs: Tensor,
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """One decode step: logits (B, V), new state, attention weights."""
    pre_vocab, new_state, weights = decoder_core_step(
        dec, config, dec.embedding(input_token), state, encoder_outputs, attn_cache,
        encoder_mask,
    )
    return linear(dec.output_projection, pre_vocab), new_state, weights


def decoder_step_beam_core(
    dec: Decoder,
    config: Config,
    input_tokens: Tensor,      # (B, K)
    state: State,              # (L, B*K, H)
    encoder_outputs: Tensor,   # (B, S, E), not beam-expanded
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """Beam step up to the pre-vocab state (B*K, H); the encoder-side
    tensors are shared by the K beams of a clip."""
    B, K = input_tokens.shape
    embedded = dec.embedding(input_tokens).reshape(B * K, -1)  # (B*K, emb)
    context = weights = None
    lstm_in = embedded
    if dec.use_attention:
        top_hidden = state[0][-1].reshape(B, K, -1)
        context, weights = attend_beam(config, dec.attention, attn_cache, encoder_outputs,
                                       top_hidden, encoder_mask)  # (B, K, E)
        context = context.reshape(B * K, -1)
        lstm_in = torch.cat([embedded, context], dim=-1)
    lstm_top, new_state = _lstm_stack_step(dec, config, lstm_in, state)
    return _deep_output(dec, lstm_top, context, embedded), new_state, weights


def decoder_step_beam(
    dec: Decoder,
    config: Config,
    input_tokens: Tensor,
    state: State,
    encoder_outputs: Tensor,
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """Beam step -> logits (B*K, V)."""
    pre_vocab, new_state, weights = decoder_step_beam_core(
        dec, config, input_tokens, state, encoder_outputs, attn_cache, encoder_mask,
    )
    return linear(dec.output_projection, pre_vocab), new_state, weights


def apply_decoder(
    dec: Decoder,
    config: Config,
    encoder_outputs: Tensor,      # (B, S, E)
    encoder_final_state: Tensor,  # (B, E)
    target_tokens: Tensor,        # (B, T) input tokens, already shifted
    encoder_mask: Optional[Tensor] = None,  # (B, S)
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Tensor]:
    """Teacher-forcing forward pass: ``logits`` (B, T, V) and, with
    attention, ``attention_weights`` (B, T, S)."""
    B, T = target_tokens.shape
    S = encoder_outputs.shape[1]
    p_drop = config.model.decoder_dropout
    h_prev, c_prev = init_hidden_state(dec, config, encoder_final_state)
    embedded_all = dropout(dec.embedding(target_tokens), p_drop, generator, train)
    cache = precompute_attention(dec, encoder_outputs)

    l1 = dec.lstm.layer(0)
    emb_dim = embedded_all.shape[-1]
    emb_gates_all = (embedded_all @ l1["w_ih"][:, :emb_dim].T
                     + l1["b_ih"] + l1["b_hh"])  # (B, T, 4H)
    # The recurrent and context products promote as jnp's ``@`` does.
    wdt = torch.promote_types(h_prev.dtype, l1["w_hh"].dtype)
    w_ctx_t = l1["w_ih"][:, emb_dim:].T.to(wdt)  # (E, 4H); empty without attention
    w_hh1_t = l1["w_hh"].T.to(wdt)

    def attn_step(top_hidden: Tensor, scale: Optional[Tensor]):
        return attend(config, dec.attention, cache, encoder_outputs, top_hidden, encoder_mask,
                      train=train, weight_scale=scale)

    remat = train and config.training.remat_attention and torch.is_grad_enabled()
    tops, contexts, weights = [], [], []
    for t in range(T):
        gates1 = emb_gates_all[:, t]
        if dec.use_attention:
            scale = (dropout_mask(dropout_shape(dec.attention, B, S), ATTN_DROPOUT, generator,
                                  encoder_outputs.device) if train else None)
            if remat:
                context, w = checkpoint(attn_step, h_prev[-1], scale, use_reentrant=False)
            else:
                context, w = attn_step(h_prev[-1], scale)
            gates1 = gates1 + context.to(wdt) @ w_ctx_t
            contexts.append(context)
            weights.append(w)
        h_top, c1 = gates_tail(gates1 + h_prev[0].to(wdt) @ w_hh1_t, c_prev[0])
        hs, cs = [h_top], [c1]
        for l in range(1, dec.lstm.num_layers):
            inp = dropout(hs[-1], p_drop, generator, train)
            h_l, c_l = lstm_cell(dec.lstm.layer(l), inp, h_prev[l], c_prev[l])
            hs.append(h_l)
            cs.append(c_l)
            h_top = h_l
        h_prev, c_prev = torch.stack(hs), torch.stack(cs)
        tops.append(h_top)

    top_seq = torch.stack(tops, dim=1)
    if not dec.use_attention:
        return {"logits": linear(dec.output_projection, top_seq)}
    pre_vocab = _deep_output(dec, top_seq, torch.stack(contexts, dim=1), embedded_all)
    return {"logits": linear(dec.output_projection, pre_vocab),
            "attention_weights": torch.stack(weights, dim=1)}
