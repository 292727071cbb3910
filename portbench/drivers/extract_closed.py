"""One client, closed loop: ``FeatureExtractor.extract_video`` on one
decoded clip of ``frames`` uint8 frames at a time (forwards of ``batch``
frames and one of the rest). Produces ``frames_per_s``: the frames turned
into features and returned to the host over the whole window.

Set-up draws the ResNet-50 weights from the seed, writes them as a weight
file under TMPDIR for ``FeatureExtractor`` to load, makes a pool of clips
and warms up the forwards of one clip."""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import faults, inputs
from portbench.harness.loop import (Window, closed_loop, program_config, reference_precision,
                                    spanned)


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, trace: bool):
        from video_captioning_tpu_torch.models.backbones import FeatureExtractor

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        bb = config["backbone"]
        self.weights = inputs.resnet50_weights(seed, device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet50.npz")
            np.savez(path, **{k: v.cpu().numpy() for k, v in self.weights.items()})
            self.extractor = FeatureExtractor(
                bb["model_type"], program_config(config), weights_path=path,
                batch_size=mix["batch"], variant=bb["variant"],
                compute_dtype=bb["compute_dtype"], device=device)
        self.pool = inputs.frame_pool(mix["pool"], mix["frames"], mix["height"], mix["width"],
                                      seed, device)
        extract = self.extractor.extract_video
        self.extract = spanned("pb.extract_video", extract) if trace else extract
        for _ in range(2):
            self.extract(self.pool[0])
        if device != "cpu":
            torch.cuda.synchronize()

    def window(self, seconds: float, trace: bool) -> Window:
        mix = self.mix
        order = inputs.clip_order(self.seed, mix["pool"], mix["max_calls"])
        self.served: List[tuple] = []  # (clip id, features (frames, 2048))

        def call(i: int) -> int:
            feats = self.extract(self.pool[order[i]])
            self.served.append((int(order[i]), feats))
            return feats.shape[0]

        w = closed_loop(call, seconds, mix["max_calls"], mix["trace_after_calls"],
                        mix["trace_calls"], trace)
        w.attempted = w.calls
        w.end_to_end = {"frames_per_s": w.items / w.seconds}
        return w

    def free(self) -> None:
        self.extractor = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        pick = inputs.sample_indices(self.seed, len(self.served), self.mix["check_clips"])
        return judge(self.weights, self.pool, [self.served[j] for j in pick], self.device)


def judge(weights, pool, served, device) -> Dict[str, float]:
    """The worst ``feature_rel_err`` of the reference over (clip, features)."""
    from portbench.reference import resnet50

    worst = -np.inf
    with reference_precision(tf32=False), torch.no_grad():
        for clip, feats in served:
            frames = torch.from_numpy(pool[clip]).to(device)
            got = resnet50.judge(weights, frames, torch.as_tensor(feats).to(device))
            worst = max(worst, float(got["feature_rel_err"].max()))
    return {"feature_rel_err": worst}


def control(config: dict, mix: dict, seed: int, device: str) -> Dict[str, float]:
    """The control: the reference's forward in TF32 put in the program's
    place, on the clips a run's check samples."""
    from portbench.reference import resnet50

    weights = inputs.resnet50_weights(seed, device)
    pool = inputs.frame_pool(mix["pool"], mix["frames"], mix["height"], mix["width"], seed,
                             device)
    served = []
    with torch.no_grad(), reference_precision(tf32=True):
        for clip in inputs.sample_indices(seed, mix["pool"], mix["check_clips"]):
            served.append((clip, resnet50.features(weights, torch.from_numpy(pool[clip])
                                                   .to(device))))
    return judge(weights, pool, served, device)


# The faults this timed path can have (one card: no exchange between cards).
FAULTS = {"half_batch": faults.half_frames, "answer_altered": faults.answer_altered}
