"""Opt-in W8A8 quantization of the decode path.

Counterpart of video_captioning_tpu/models/quantize.py:

* ``level="vocab"`` quantizes the vocabulary projection (the decoder's
  ``output_projection``), in both families;
* ``level="full"`` also quantizes every transformer decoder block's
  ``self_attn`` / ``cross_attn`` ``wq wk wv wo`` and ``mlp`` ``fc1 fc2``.
  The LSTM family's gate matrices stay as they are at every level.

Weights get static per-output-channel scales
(``layers.quantize_linear_int8``), activations dynamic per-row scales at
each call (``layers.int8_linear``). Tokens are approximate against float32
by construction, so the token-parity contract does not apply to a
quantized model. The transform is applied at load by
``VideoCaptionPredictor(decode_int8=...)`` / ``cli.serve --decode-int8``,
never in training.
"""

from __future__ import annotations

import copy

from torch import nn

from ..config import Config
from .layers import quantize_linear_int8

LEVELS = ("off", "vocab", "full")
_BLOCK_LINEARS = (("self_attn", ("wq", "wk", "wv", "wo")),
                  ("cross_attn", ("wq", "wk", "wv", "wo")),
                  ("mlp", ("fc1", "fc2")))


def quantize_decode_params(model: nn.Module, config: Config, level: str) -> nn.Module:
    """A copy of the captioner ``model`` with the decode linears of
    ``level`` in W8A8 form (:class:`layers.Int8Linear`); ``"off"`` returns
    ``model`` itself."""
    if level not in LEVELS:
        raise ValueError(f"decode_int8 must be one of {LEVELS}, got {level!r}")
    if level == "off":
        return model
    model = copy.deepcopy(model)
    dec = model.decoder
    dec.output_projection = quantize_linear_int8(dec.output_projection)
    if level == "full" and config.model.architecture == "transformer":
        for blk in dec.blocks:
            for sub_name, names in _BLOCK_LINEARS:
                sub = getattr(blk, sub_name)
                for name in names:
                    setattr(sub, name, quantize_linear_int8(getattr(sub, name)))
    return model
