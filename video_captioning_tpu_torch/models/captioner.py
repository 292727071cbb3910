"""Composed captioning model (encoder + decoder), ``encode`` and the
teacher-forced ``apply_model``.

Counterpart of video_captioning_tpu/models/captioner.py for the LSTM
family. Configurations the port cannot run yet raise here, when the model
is built, rather than being ignored.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config

from .decoder import Decoder, apply_decoder
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
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (encoder_outputs, final_state, mask); the mask defaults to
    all frames valid."""
    enc_outs, final = apply_encoder(model.encoder, config, video_features, video_mask,
                                    train=train, generator=generator)
    if video_mask is None:
        video_mask = torch.ones(video_features.shape[:2], dtype=enc_outs.dtype,
                                device=enc_outs.device)
    return enc_outs, final, video_mask


def apply_model(
    model: VideoCaptioningModel,
    config: Config,
    video_features: Tensor,
    input_tokens: Tensor,
    video_mask: Optional[Tensor] = None,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Tensor]:
    """Training forward pass (teacher forcing): ``logits`` (B, T, V),
    ``encoder_outputs`` and ``attention_weights``."""
    enc_outs, final, mask = encode(model, config, video_features, video_mask,
                                   train=train, generator=generator)
    dec_out = apply_decoder(model.decoder, config, enc_outs, final, input_tokens, mask,
                            train=train, generator=generator)
    return {"logits": dec_out["logits"], "encoder_outputs": enc_outs,
            "attention_weights": dec_out["attention_weights"]}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
