from typing import Dict, Optional

import torch

from ..config import Config

from ..models.captioner import VideoCaptioningModel, encode
from .beam import beam_search_generate  # noqa: F401
from .greedy import greedy_generate  # noqa: F401

SAMPLE_NOT_PORTED = ("method='sample' is not ported to video_captioning_tpu_torch yet "
                     "(ROADMAP.md A4, the other decoder options)")


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
        raise NotImplementedError(SAMPLE_NOT_PORTED)
    else:
        raise ValueError(f"Unsupported generation method: {method}")
    return fn(model, config, enc_outs, final, start_token_id, end_token_id,
              max_length, mask, **kwargs)
