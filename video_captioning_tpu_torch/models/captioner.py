"""Composed captioning model (encoder + decoder), ``encode`` and the
teacher-forced ``apply_model``.

Counterpart of video_captioning_tpu/models/captioner.py for both model
families, dispatched on ``model.architecture`` in :func:`is_transformer`
alone. Configurations the port cannot run yet raise here, when the model
is built, rather than being ignored.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config

from . import transformer as transformer_mod
from .decoder import Decoder, apply_decoder
from .encoder import Encoder, apply_encoder

Tensor = torch.Tensor


def is_transformer(config: Config) -> bool:
    return config.model.architecture == "transformer"


def check_supported(config: Config) -> None:
    """Raise NotImplementedError for what the port does not run yet.

    The transformer family reads none of the LSTM decoder's options; of its
    own, ``transformer_cross_kv_bf16`` stores the cross keys and values in
    bfloat16, which changes results on every backend, so it is refused
    (the others: generation/families.py:_transformer_family). The LSTM
    family runs every attention type, ``use_attention=False`` and
    ``kernels.attention_score_bf16``."""
    m, k = config.model, config.kernels
    if is_transformer(config):
        unsupported = [(k.transformer_cross_kv_bf16, "kernels.transformer_cross_kv_bf16")]
    else:
        unsupported = [(m.architecture != "lstm", f"architecture={m.architecture!r}")]
    unsupported.append((config.parallel.context_axis is not None, "parallel.context_axis"))
    names = [name for bad, name in unsupported if bad]
    if names:
        raise NotImplementedError(
            f"not ported to video_captioning_tpu_torch yet: {', '.join(names)}"
        )


class VideoCaptioningModel(nn.Module):
    def __init__(self, config: Config, vocab_size: int):
        super().__init__()
        check_supported(config)
        if is_transformer(config):
            self.encoder = transformer_mod.TransformerEncoder(config)
            self.decoder = transformer_mod.TransformerDecoder(config, vocab_size)
        else:
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
    apply = transformer_mod.apply_transformer_encoder if is_transformer(config) else apply_encoder
    enc_outs, final = apply(model.encoder, config, video_features, video_mask,
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
    ``encoder_outputs`` and ``attention_weights`` (None for an LSTM
    decoder without attention). Dropout draws from
    ``generator`` in order, the encoder's sites before the decoder's."""
    enc_outs, final, mask = encode(model, config, video_features, video_mask,
                                   train=train, generator=generator)
    if is_transformer(config):
        # As in the JAX package, the decoder sees no mask when none was given.
        dec_out = transformer_mod.apply_transformer_decoder(
            model.decoder, config, enc_outs, input_tokens, None if video_mask is None else mask,
            train=train, generator=generator)
    else:
        dec_out = apply_decoder(model.decoder, config, enc_outs, final, input_tokens, mask,
                                train=train, generator=generator)
    return {"logits": dec_out["logits"], "encoder_outputs": enc_outs,
            "attention_weights": dec_out.get("attention_weights")}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
