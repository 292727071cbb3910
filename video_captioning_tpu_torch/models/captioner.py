"""Composed captioning model (encoder + decoder) and ``encode``.

Counterpart of video_captioning_tpu/models/captioner.py for the LSTM
family. Configurations the port cannot run yet raise here, when the model
is built, rather than being ignored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from video_captioning_tpu.config import Config

from .decoder import Decoder
from .encoder import Encoder, apply_encoder

Tensor = torch.Tensor


def check_supported(config: Config) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    m, k = config.model, config.kernels
    unsupported = [
        (m.architecture != "lstm", f"architecture={m.architecture!r}"),
        (not m.use_attention, "use_attention=False"),
        (m.attention_type != "bahdanau", f"attention_type={m.attention_type!r}"),
        (k.use_pallas_attention, "kernels.use_pallas_attention"),
        (k.use_pallas_lstm, "kernels.use_pallas_lstm"),
        (k.use_fused_vocab_topk, "kernels.use_fused_vocab_topk"),
        (k.attention_score_bf16, "kernels.attention_score_bf16"),
        (config.parallel.context_axis is not None, "parallel.context_axis"),
    ]
    names = [name for bad, name in unsupported if bad]
    if names:
        raise NotImplementedError(
            f"not ported to video_captioning_tpu_torch yet: {', '.join(names)}"
        )


class VideoCaptioningModel(nn.Module):
    def __init__(self, config: Config, vocab_size: int):
        super().__init__()
        check_supported(config)
        self.encoder = Encoder(config)
        self.decoder = Decoder(config, vocab_size)


def encode(
    model: VideoCaptioningModel,
    config: Config,
    video_features: Tensor,
    video_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (encoder_outputs, final_state, mask); the mask defaults to
    all frames valid."""
    enc_outs, final = apply_encoder(model.encoder, config, video_features, video_mask)
    if video_mask is None:
        video_mask = torch.ones(video_features.shape[:2], dtype=enc_outs.dtype,
                                device=enc_outs.device)
    return enc_outs, final, video_mask
