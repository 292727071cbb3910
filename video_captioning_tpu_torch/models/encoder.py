"""BiLSTM video encoder.

Counterpart of video_captioning_tpu/models/encoder.py (apply_encoder):
feature projection (F -> H) -> dropout -> N bidirectional LSTM layers
(dropout between layers) -> output projection (2H -> H) -> dropout. The
final state is the output projection of the last layer's forward and
backward final h, concatenated. Dropout runs only with ``train=True`` and
a generator.

Kernel dispatch follows the JAX package, on CUDA tensors or with
``kernels.interpret`` set (on CPU that is each op's plain version under
the same bf16-operand contract): at eval the ``lstm_seq`` op when
``kernels.use_pallas_lstm_seq`` is on, in training the differentiable
``lstm_seq_train`` op when ``kernels.use_pallas_lstm_seq_train`` is on,
each within its domain (``ops.lstm_seq.lstm_seq_eligible``: on CUDA, H up
to the kernel's limit). Otherwise the float32 ``lstm_scan`` runs, under
autograd in training: the path the flags-off configuration and the JAX
package's ``lax.scan`` take. The domain decision is made once per encoder,
device, dtype and mode, before any launch, and logged with H and the limit.

With bfloat16 parameters (``compute_dtype="bfloat16"`` serving) the
activations stay float32 as in the JAX package: the projections take
``layers.linear``'s rule, the input-side products of the recurrence are
float32 products of the bfloat16 weights, and ``lstm_seq`` gets float32
``xproj`` with the bfloat16 recurrent weights it always takes.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config

from ..ops.build import tracing
from ..ops.lstm_seq import kernel_max_hidden, lstm_seq, lstm_seq_eligible
from ..ops.lstm_seq_train import lstm_seq_train
from .layers import LSTMWeights, dropout, linear, lstm_scan, promote, reverse_sequence

Tensor = torch.Tensor
logger = logging.getLogger(__name__)


class Encoder(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        F, H, L = m.cnn_feature_dim, m.encoder_hidden_dim, m.encoder_num_layers
        self.feature_projection = nn.Linear(F, H)
        self.lstm = LSTMWeights(H, H, L, bidirectional=True)
        self.output_projection = nn.Linear(2 * H, H)
        self._staged: Dict[int, Tuple[tuple, Tensor]] = {}
        self._kernel_route: Dict[tuple, bool] = {}

    def takes_kernel(self, dtype: torch.dtype, device: torch.device, train: bool) -> bool:
        """``lstm_seq_eligible`` for this encoder's H, decided once per
        (device, dtype, mode) and logged with H and the kernel's limit."""
        key = (device, dtype, train)
        if key not in self._kernel_route:
            H = self.lstm.hidden_size
            ok = lstm_seq_eligible(H, dtype, device, train)
            kernel = "lstm_seq_train" if train else "lstm_seq"
            limit = kernel_max_hidden(train) if device.type == "cuda" else "none (plain version)"
            logger.info(f"lstm_seq_eligible: encoder H={H}, {kernel} limit {limit} on "
                        f"{device.type}, {dtype}: the encoder runs "
                        f"{kernel if ok else 'lstm_scan (float32, no kernel)'}")
            self._kernel_route[key] = ok
        return self._kernel_route[key]

    def stacked_w_hh_bf16(self, l: int) -> Tensor:
        """Layer l's (2, H, 4H) bf16 recurrent weights for ``lstm_seq``,
        cast once and reused until the weights change or move. Detached:
        eval only (training passes the float32 stack to lstm_seq_train)."""
        fwd, bwd = self.lstm.layer(l)["w_hh"], self.lstm.layer(l, reverse=True)["w_hh"]
        if tracing():  # torch.export: the cast is part of the program
            return torch.stack([fwd.detach().T, bwd.detach().T]).to(torch.bfloat16).contiguous()
        key = tuple((w.device, w.data_ptr(), w._version) for w in (fwd, bwd))
        hit = self._staged.get(l)
        if hit is None or hit[0] != key:
            w = torch.stack([fwd.detach().T, bwd.detach().T]).to(torch.bfloat16).contiguous()
            hit = self._staged[l] = (key, w)
        return hit[1]


def apply_encoder(
    encoder: Encoder,
    config: Config,
    video_features: Tensor,
    video_mask: Optional[Tensor] = None,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor]:
    """video_features (B, T, F), video_mask (B, T) with 1 = valid, or None.
    Returns encoded (B, T, H) and final_hidden (B, H)."""
    p_drop = config.model.encoder_dropout
    x = linear(encoder.feature_projection, video_features)  # (B, T, H)
    x = dropout(x, p_drop, generator, train)
    lengths = None if video_mask is None else video_mask.sum(dim=1).to(torch.int64)
    k = config.kernels
    flag = k.use_pallas_lstm_seq_train if train else k.use_pallas_lstm_seq
    use_kernel = (flag and (x.is_cuda or k.interpret)
                  and encoder.takes_kernel(x.dtype, x.device, train))
    num_layers = encoder.lstm.num_layers
    h_fwd_last = h_bwd_last = None
    for l in range(num_layers):
        fwd, bwd = encoder.lstm.layer(l), encoder.lstm.layer(l, reverse=True)
        # Both directions run forward in time: the backward one over each
        # row's valid prefix reversed (packed-sequence semantics), its
        # outputs un-reversed afterwards.
        x_rev = reverse_sequence(x, lengths)
        xs2 = torch.stack([x, x_rev])  # (2, B, T, in)
        if use_kernel:
            w_ih = torch.stack([fwd["w_ih"], bwd["w_ih"]])  # (2, 4H, in)
            bias = torch.stack([fwd["b_ih"] + fwd["b_hh"], bwd["b_ih"] + bwd["b_hh"]])
            xproj = torch.einsum("dbti,doi->dbto", *promote(xs2, w_ih)) + bias[:, None, None, :]
            xproj_t = xproj.permute(2, 0, 1, 3).contiguous()  # (T, 2, B, 4H)
            mask = None if video_mask is None else video_mask.contiguous()
            if train:
                # The differentiable float32 stack: the op casts it to bf16.
                w_hh = torch.stack([fwd["w_hh"].T, bwd["w_hh"].T])  # (2, H, 4H)
                outs_t, (h_last2, _) = lstm_seq_train(xproj_t, w_hh, mask)
            else:
                outs_t, (h_last2, _) = lstm_seq(xproj_t, encoder.stacked_w_hh_bf16(l), mask)
            outs2 = outs_t.permute(1, 2, 0, 3)  # (2, B, T, H)
        else:
            B, Hd = x.shape[0], fwd["w_hh"].shape[1]
            h0 = torch.zeros((B, Hd), dtype=x.dtype, device=x.device)
            runs = [lstm_scan(p, xs, h0, h0, mask=video_mask) for p, xs in zip((fwd, bwd), xs2)]
            outs2 = torch.stack([r[0] for r in runs])
            h_last2 = torch.stack([r[1][0] for r in runs])
        out_b = reverse_sequence(outs2[1], lengths)
        x = torch.cat([outs2[0], out_b], dim=-1)  # (B, T, 2H)
        if l < num_layers - 1:  # torch's inter-layer dropout
            x = dropout(x, p_drop, generator, train)
        h_fwd_last, h_bwd_last = h_last2[0], h_last2[1]

    encoded = dropout(linear(encoder.output_projection, x), p_drop, generator, train)
    final_hidden = linear(encoder.output_projection, torch.cat([h_fwd_last, h_bwd_last], dim=-1))
    return encoded, final_hidden
