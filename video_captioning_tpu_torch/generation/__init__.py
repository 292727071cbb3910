from typing import Dict, Optional

import torch

from video_captioning_tpu.config import Config

from ..models.captioner import VideoCaptioningModel, encode
from .beam import beam_search_generate  # noqa: F401
from .greedy import greedy_generate  # noqa: F401


def generate(
    model: VideoCaptioningModel,
    config: Config,
    video_features: torch.Tensor,
    start_token_id: int,
    end_token_id: int,
    max_length: int = 20,
    video_mask: Optional[torch.Tensor] = None,
    method: str = "greedy",
    **kwargs,
) -> Dict[str, torch.Tensor]:
    """Encode, then decode with ``method`` ("greedy" or "beam")."""
    enc_outs, final, mask = encode(model, config, video_features, video_mask)
    if method == "greedy":
        fn = greedy_generate
    elif method == "beam":
        fn = beam_search_generate
    elif method == "sample":
        raise NotImplementedError("method='sample' is not ported to video_captioning_tpu_torch yet")
    else:
        raise ValueError(f"Unsupported generation method: {method}")
    return fn(model, config, enc_outs, final, start_token_id, end_token_id,
              max_length, mask, **kwargs)
