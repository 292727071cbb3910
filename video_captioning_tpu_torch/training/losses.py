"""Loss functions.

Counterpart of video_captioning_tpu/training/losses.py: label-smoothed
cross entropy with PAD masking, numerically
``torch.nn.CrossEntropyLoss(ignore_index=pad, label_smoothing=ls)`` as the
upstream trainer uses it:

* per-token loss = (1 - ls) NLL(target) + ls mean_j(-log p_j) over all V
  classes (PAD's column included: torch smooths over every class),
* tokens whose *target* is PAD are excluded from the mean.

Reductions run in float32 whatever the logits' type.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def label_smoothed_cross_entropy(
    logits: Tensor,
    targets: Tensor,
    pad_idx: int = 0,
    label_smoothing: float = 0.0,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Mean label-smoothed CE over non-PAD tokens: logits (..., V), integer
    targets (...), optional extra per-token weights. A float32 scalar."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        per_token = (1.0 - label_smoothing) * nll + label_smoothing * -log_probs.mean(dim=-1)
    else:
        per_token = nll
    mask = (targets != pad_idx).float()
    if weights is not None:
        mask = mask * weights.float()
    return (per_token * mask).sum() / mask.sum().clamp_min(1.0)
