"""Attention LSTM caption decoder, one decode step at a time.

Counterpart of video_captioning_tpu/models/decoder.py (init_hidden_state,
decoder_core_step, decoder_step, decoder_step_beam(_core)): embedding ->
Bahdanau attention over the encoder outputs with the previous top-layer h
-> LSTM stack on [embedding ; context] -> deep output
tanh(W [lstm_top ; context ; embedding]) -> vocabulary projection. The
state is (h, c), each (L, N, H). Teacher forcing (apply_decoder) belongs to
training and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from video_captioning_tpu.config import Config

from .attention import BahdanauAttention, attend, attend_beam
from .layers import LSTMWeights, lstm_cell

Tensor = torch.Tensor
State = Tuple[Tensor, Tensor]


class Decoder(nn.Module):
    def __init__(self, config: Config, vocab_size: int):
        super().__init__()
        m = config.model
        emb, H, E = m.embedding_dim, m.decoder_hidden_dim, m.encoder_hidden_dim
        self.embedding = nn.Embedding(vocab_size, emb)
        self.attention = BahdanauAttention(config)
        self.lstm = LSTMWeights(emb + E, H, m.decoder_num_layers)
        self.context_projection = nn.Linear(E + H + emb, H)
        self.output_projection = nn.Linear(H, vocab_size)
        if E != H:
            self.init_state_projection = nn.Linear(E, H)


def init_hidden_state(dec: Decoder, config: Config, encoder_final_state: Tensor) -> State:
    """The (projected) encoder final state in every layer; zero cell."""
    projected = encoder_final_state
    if hasattr(dec, "init_state_projection"):
        projected = dec.init_state_projection(projected)
    h = projected[None].expand((config.model.decoder_num_layers,) + projected.shape)
    return h, torch.zeros_like(h)


def _lstm_stack_step(dec: Decoder, x: Tensor, state: State) -> Tuple[Tensor, State]:
    h_prev, c_prev = state
    hs, cs = [], []
    inp = x
    for l in range(dec.lstm.num_layers):
        h_new, c_new = lstm_cell(dec.lstm.layer(l), inp, h_prev[l], c_prev[l])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, (torch.stack(hs), torch.stack(cs))


def decoder_core_step(
    dec: Decoder,
    embedded: Tensor,          # (B, emb)
    state: State,
    encoder_outputs: Tensor,   # (B, S, E)
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """Returns the pre-vocab state (B, H), the new state, weights (B, S)."""
    context, weights = attend(dec.attention, attn_cache, encoder_outputs,
                              state[0][-1], encoder_mask)
    lstm_top, new_state = _lstm_stack_step(dec, torch.cat([embedded, context], dim=-1), state)
    pre_vocab = torch.tanh(dec.context_projection(torch.cat([lstm_top, context, embedded], dim=-1)))
    return pre_vocab, new_state, weights


def decoder_step(
    dec: Decoder,
    input_token: Tensor,       # (B,) token ids
    state: State,
    encoder_outputs: Tensor,
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """One decode step: logits (B, V), new state, attention weights."""
    pre_vocab, new_state, weights = decoder_core_step(
        dec, dec.embedding(input_token), state, encoder_outputs, attn_cache, encoder_mask,
    )
    return dec.output_projection(pre_vocab), new_state, weights


def decoder_step_beam_core(
    dec: Decoder,
    input_tokens: Tensor,      # (B, K)
    state: State,              # (L, B*K, H)
    encoder_outputs: Tensor,   # (B, S, E), not beam-expanded
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """Beam step up to the pre-vocab state (B*K, H); the encoder-side
    tensors are shared by the K beams of a clip."""
    B, K = input_tokens.shape
    embedded = dec.embedding(input_tokens)  # (B, K, emb)
    top_hidden = state[0][-1].reshape(B, K, -1)
    context, weights = attend_beam(dec.attention, attn_cache, encoder_outputs,
                                   top_hidden, encoder_mask)  # (B, K, E)
    lstm_in = torch.cat([embedded, context], dim=-1).reshape(B * K, -1)
    lstm_top, new_state = _lstm_stack_step(dec, lstm_in, state)
    deep_in = torch.cat(
        [lstm_top, context.reshape(B * K, -1), embedded.reshape(B * K, -1)], dim=-1
    )
    return torch.tanh(dec.context_projection(deep_in)), new_state, weights


def decoder_step_beam(
    dec: Decoder,
    input_tokens: Tensor,
    state: State,
    encoder_outputs: Tensor,
    attn_cache: Dict[str, Tensor],
    encoder_mask: Optional[Tensor],
) -> Tuple[Tensor, State, Tensor]:
    """Beam step -> logits (B*K, V)."""
    pre_vocab, new_state, weights = decoder_step_beam_core(
        dec, input_tokens, state, encoder_outputs, attn_cache, encoder_mask,
    )
    return dec.output_projection(pre_vocab), new_state, weights
