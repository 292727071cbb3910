"""Host-side video frame extraction (numpy and OpenCV, no torch).

The port's copy of ``uniform_frame_indices``, ``extract_frames`` and
``pixel_stub_features`` from video_captioning_tpu/data/video.py: uniform ``linspace`` sampling of
``num_frames`` frames in one sequential decode pass, BGR -> RGB, an
optional resize, and padding with the last frame (``pad_mode="last"``) or
zeros (``"zero"``). ``cv2`` is imported when a video is decoded, so the
module imports where OpenCV is absent. Normalization is not done here: it
runs on the device with the CNN (models.backbones).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def uniform_frame_indices(total_frames: int, num_frames: int) -> np.ndarray:
    """linspace sampling identical to the reference (preprocess.py:98-101)."""
    if total_frames <= num_frames:
        return np.arange(total_frames)
    return np.linspace(0, total_frames - 1, num_frames, dtype=int)


def extract_frames(
    video_path: Path,
    num_frames: int = 80,
    *,
    resize: Optional[Tuple[int, int]] = None,
    pad_mode: str = "last",
) -> np.ndarray:
    """Decode a video into (num_frames, H, W, 3) uint8 RGB.

    resize: optional (height, width) applied per frame.
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV (cv2) is required for video decoding") from e

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise ValueError(f"Cannot open video: {video_path}")

    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        # Streams / some AVIs / broken headers report 0 frames; counting
        # with grab() (no frame copies) then reopening costs one cheap
        # pass but keeps the clip decodable instead of silently blank.
        while cap.grab():
            total += 1
        cap.release()
        if total <= 0:
            raise ValueError(f"No decodable frames in video: {video_path}")
        logger.warning(
            f"{video_path} reports no frame count; counted {total} frames"
        )
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise ValueError(f"Cannot reopen video: {video_path}")
    wanted = set(uniform_frame_indices(total, num_frames).tolist())

    frames: List[np.ndarray] = []
    pos = 0
    while pos < total and len(frames) < min(num_frames, total):
        # grab() advances the decoder without the retrieve() frame copy;
        # unwanted frames (total > num_frames) skip the copy entirely.
        if not cap.grab():
            break
        if pos in wanted:
            ret, frame = cap.retrieve()
            if not ret:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resize is not None:
                frame = cv2.resize(frame, (resize[1], resize[0]))
            frames.append(frame)
        pos += 1
    cap.release()

    if not frames:
        h, w = resize if resize is not None else (480, 640)
        frames = [np.zeros((h, w, 3), dtype=np.uint8)]
        logger.warning(f"No frames decoded from {video_path}; using a blank frame")

    while len(frames) < num_frames:
        if pad_mode == "last":
            frames.append(frames[-1].copy())
        elif pad_mode == "zero":
            frames.append(np.zeros_like(frames[0]))
        else:
            raise ValueError(f"Unknown pad_mode: {pad_mode}")

    return np.stack(frames[:num_frames])


def pixel_stub_features(frames: np.ndarray, feature_dim: int = 4096) -> np.ndarray:
    """The upstream predictor's on-the-fly "features": each frame's
    flattened pixels, truncated or zero-padded to ``feature_dim``, as
    float32 (a compatibility mode; ``feature_mode="cnn"`` runs a backbone)."""
    out = []
    for frame in frames:
        flat = frame.reshape(-1)[:feature_dim].astype(np.float32)
        if flat.size < feature_dim:
            flat = np.pad(flat, (0, feature_dim - flat.size))
        out.append(flat)
    return np.stack(out)
