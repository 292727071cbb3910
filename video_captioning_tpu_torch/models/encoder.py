"""BiLSTM video encoder.

Counterpart of video_captioning_tpu/models/encoder.py (apply_encoder, eval
path): feature projection (F -> H) -> N bidirectional LSTM layers ->
output projection (2H -> H). The final state is the output projection of
the last layer's forward and backward final h, concatenated.

Kernel dispatch follows the JAX package: the ``lstm_seq`` op runs a
layer's recurrence when ``kernels.use_pallas_lstm_seq`` is on and the
tensors are on CUDA or ``kernels.interpret`` is set (on CPU that is the
op's plain version under the same bf16-operand contract); otherwise the
float32 ``lstm_scan`` runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from video_captioning_tpu.config import Config

from ..ops.lstm_seq import lstm_seq
from .layers import LSTMWeights, lstm_scan, reverse_sequence

Tensor = torch.Tensor


class Encoder(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        F, H, L = m.cnn_feature_dim, m.encoder_hidden_dim, m.encoder_num_layers
        self.feature_projection = nn.Linear(F, H)
        self.lstm = LSTMWeights(H, H, L, bidirectional=True)
        self.output_projection = nn.Linear(2 * H, H)
        self._staged: Dict[int, Tuple[tuple, Tensor]] = {}

    def stacked_w_hh_bf16(self, l: int) -> Tensor:
        """Layer l's (2, H, 4H) bf16 recurrent weights for ``lstm_seq``,
        cast once and reused until the weights change or move."""
        fwd, bwd = self.lstm.layer(l)["w_hh"], self.lstm.layer(l, reverse=True)["w_hh"]
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
) -> Tuple[Tensor, Tensor]:
    """video_features (B, T, F), video_mask (B, T) with 1 = valid, or None.
    Returns encoded (B, T, H) and final_hidden (B, H)."""
    x = encoder.feature_projection(video_features)  # (B, T, H)
    lengths = None if video_mask is None else video_mask.sum(dim=1).to(torch.int64)
    use_seq_kernel = (
        config.kernels.use_pallas_lstm_seq
        and x.dtype in (torch.float32, torch.bfloat16)
        and (x.is_cuda or config.kernels.interpret)
    )
    h_fwd_last = h_bwd_last = None
    for l in range(encoder.lstm.num_layers):
        fwd, bwd = encoder.lstm.layer(l), encoder.lstm.layer(l, reverse=True)
        # Both directions run forward in time: the backward one over each
        # row's valid prefix reversed (packed-sequence semantics), its
        # outputs un-reversed afterwards.
        x_rev = reverse_sequence(x, lengths)
        xs2 = torch.stack([x, x_rev])  # (2, B, T, in)
        if use_seq_kernel:
            w_ih = torch.stack([fwd["w_ih"], bwd["w_ih"]])  # (2, 4H, in)
            bias = torch.stack([fwd["b_ih"] + fwd["b_hh"], bwd["b_ih"] + bwd["b_hh"]])
            xproj = torch.einsum("dbti,doi->dbto", xs2, w_ih) + bias[:, None, None, :]
            xproj_t = xproj.permute(2, 0, 1, 3).contiguous()  # (T, 2, B, 4H)
            mask = None if video_mask is None else video_mask.contiguous()
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
        h_fwd_last, h_bwd_last = h_last2[0], h_last2[1]

    encoded = encoder.output_projection(x)
    final_hidden = encoder.output_projection(torch.cat([h_fwd_last, h_bwd_last], dim=-1))
    return encoded, final_hidden
