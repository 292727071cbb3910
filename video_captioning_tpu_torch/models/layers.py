"""LSTM parameters and the eval-time layer functions.

Counterpart of video_captioning_tpu/models/layers.py (lstm_cell,
lstm_scan, reverse_sequence). Linears and embeddings are ``nn.Linear`` /
``nn.Embedding``; an LSTM stack is :class:`LSTMWeights`, which holds its
parameters under ``torch.nn.LSTM``'s names (``weight_ih_l0``,
``bias_hh_l1_reverse``, ...) and (out, in) layout but is not an
``nn.LSTM``: the recurrence runs in the functions below or in the
``lstm_seq`` kernel. Gates are packed [i, f, g, o]. Eval only: no dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


class LSTMWeights(nn.Module):
    """Parameters of a (possibly bidirectional) LSTM stack."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        g4 = 4 * hidden_size
        for l in range(num_layers):
            in_dim = input_size if l == 0 else hidden_size * (2 if bidirectional else 1)
            for sfx in ("", "_reverse") if bidirectional else ("",):
                self.register_parameter(f"weight_ih_l{l}{sfx}", nn.Parameter(torch.empty(g4, in_dim)))
                self.register_parameter(f"weight_hh_l{l}{sfx}", nn.Parameter(torch.empty(g4, hidden_size)))
                self.register_parameter(f"bias_ih_l{l}{sfx}", nn.Parameter(torch.empty(g4)))
                self.register_parameter(f"bias_hh_l{l}{sfx}", nn.Parameter(torch.empty(g4)))

    def layer(self, l: int, reverse: bool = False) -> Dict[str, Tensor]:
        sfx = "_reverse" if reverse else ""
        return {
            "w_ih": getattr(self, f"weight_ih_l{l}{sfx}"),
            "w_hh": getattr(self, f"weight_hh_l{l}{sfx}"),
            "b_ih": getattr(self, f"bias_ih_l{l}{sfx}"),
            "b_hh": getattr(self, f"bias_hh_l{l}{sfx}"),
        }


def gates_tail(gates: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """Elementwise LSTM tail from gate pre-activations [i, f, g, o]."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(layer: Dict[str, Tensor], x: Tensor, h: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """One LSTM step. x: (N, in), h/c: (N, H) -> (h', c')."""
    gates = x @ layer["w_ih"].T + h @ layer["w_hh"].T + layer["b_ih"] + layer["b_hh"]
    return gates_tail(gates, c)


def lstm_scan(
    layer: Dict[str, Tensor],
    xs: Tensor,
    h0: Tensor,
    c0: Tensor,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """One float32 LSTM layer over time. xs: (B, T, in), mask (B, T) with
    1 = valid. Returns outputs (B, T, H) and the final (h, c).

    Masked semantics of packed sequences: at a padded step the state
    carries through and the output is zero."""
    xs_proj = xs @ layer["w_ih"].T + (layer["b_ih"] + layer["b_hh"])  # (B, T, 4H)
    w_hh_t = layer["w_hh"].T
    h, c = h0, c0
    outs = []
    for t in range(xs.shape[1]):
        h_new, c_new = gates_tail(xs_proj[:, t] + h @ w_hh_t, c)
        if mask is None:
            h, c, out = h_new, c_new, h_new
        else:
            m = (mask[:, t] > 0)[:, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            out = torch.where(m, h_new, torch.zeros_like(h_new))
        outs.append(out)
    return torch.stack(outs, dim=1), (h, c)


def reverse_sequence(x: Tensor, lengths: Optional[Tensor]) -> Tensor:
    """Reverse each row's valid prefix in a padded (B, T, ...) tensor;
    positions past a row's length stay put. ``lengths=None`` flips."""
    if lengths is None:
        return torch.flip(x, dims=(1,))
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = lengths[:, None] - 1 - t
    src = torch.where(src >= 0, src, t)  # (B, T)
    src = src.reshape(src.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, src)
