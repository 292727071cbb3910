from typing import Dict, Optional

import torch

from ..config import Config

from ..models.captioner import VideoCaptioningModel, encode
from .beam import beam_search_generate  # noqa: F401
from .greedy import greedy_generate  # noqa: F401
from .sampling import sample_generate  # noqa: F401

METHODS = {"greedy": greedy_generate, "beam": beam_search_generate, "sample": sample_generate}


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
    """Encode, then decode with ``method`` ("greedy", "beam" or "sample")."""
    if method not in METHODS:
        raise ValueError(f"Unsupported generation method: {method}")
    enc_outs, final, mask = encode(model, config, video_features, video_mask)
    return METHODS[method](model, config, enc_outs, final, start_token_id, end_token_id,
                           max_length, mask, **kwargs)
