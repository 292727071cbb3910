"""Inference helpers (counterpart of video_captioning_tpu/inference/utils.py,
which cannot be imported without JAX: its package loads the JAX predictor)."""

from __future__ import annotations

import numpy as np


def resize_feature_sequence(features: np.ndarray, target_length: int) -> np.ndarray:
    """Uniformly sample or zero-pad (T, F) features to target_length
    (torch.linspace(...).long() truncation, as upstream)."""
    seq_len = features.shape[0]
    if seq_len == target_length:
        return features
    if seq_len > target_length:
        idx = np.linspace(0, seq_len - 1, target_length)
        return features[idx.astype(np.int64)]
    pad = np.zeros((target_length - seq_len, features.shape[1]), features.dtype)
    return np.concatenate([features, pad], axis=0)
