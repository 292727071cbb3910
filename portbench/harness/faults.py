"""Faults planted under the timed path, to show that the check sees them:
the CPU tests plant each in a whole run, and ``tools/readings.py --fault``
reads what each does to the check's numbers at a cell's own size. Each
driver lists the faults its timed path can have in ``FAULTS``. A benchmark
run never plants one.

Each fault takes ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patches.setattr``) and replaces one function
of the program.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def state_unchanged(patch) -> None:
    """Every decode step hands back the state it was given, as it was
    before the step (the transformer's caches are written in place, so the
    state is copied first)."""
    from video_captioning_tpu_torch.generation import beam
    from video_captioning_tpu_torch.models.weights import tree_map

    make = beam.make_decode_family

    def frozen(*args, **kwargs):
        fam = make(*args, **kwargs)

        def step_beam(tokens, state, t):
            before = tree_map(torch.clone, state)
            logits, _, w = fam.step_beam(tokens, state, t)
            return logits, before, w

        return fam._replace(step_beam=step_beam)

    patch(beam, "make_decode_family", frozen)


def half_batch(patch) -> None:
    """The predictor decodes the first half of each batch and hands its
    results to the other half too."""
    from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor

    generate = VideoCaptionPredictor._generate

    def half(self, replica, feats, bucket, *args, **kwargs):
        n = max(1, feats.shape[0] // 2)
        out = generate(self, replica, feats[:n], bucket, *args, **kwargs)
        rows = torch.arange(max(bucket, feats.shape[0])) % n
        return {k: v[rows.to(v.device)] for k, v in out.items()}

    patch(VideoCaptionPredictor, "_generate", half)


def token_altered(patch) -> None:
    """Where the beam step's top-k produces its tokens, the best one is
    replaced by the next id (its value left as it was)."""
    from video_captioning_tpu_torch.generation import beam

    topk = beam.topk2d_lse

    def altered(logits, k):
        vals, idx, lse = topk(logits, k)
        idx = idx.clone()
        idx[:, 0] = (idx[:, 0] + 1) % logits.shape[1]
        return vals, idx, lse

    patch(beam, "topk2d_lse", altered)


def topk_ranks_shifted(patch) -> None:
    """The beam step's top-k returns the candidates of ranks 2 to k + 1,
    each with its true value: a selection that is wrong and consistent."""
    from video_captioning_tpu_torch.generation import beam

    topk = beam.topk2d_lse

    def shifted(logits, k):
        vals, idx, lse = topk(logits, k + 1)
        return vals[:, 1:].contiguous(), idx[:, 1:].contiguous(), lse

    patch(beam, "topk2d_lse", shifted)


def worst_hypothesis_served(patch) -> None:
    """The beam search serves the worst of its K final hypotheses instead
    of the best (its score, looked up beside it, is its own)."""
    from video_captioning_tpu_torch.inference import predictor

    search = predictor.beam_search_generate

    def worst(*args, **kwargs):
        out = search(*args, **kwargs)
        rank = torch.argmin(out["all_scores"], dim=1)
        rows = torch.arange(rank.shape[0], device=rank.device)
        return dict(out, generated_tokens=out["all_tokens"][rows, rank])

    patch(predictor, "beam_search_generate", worst)


def half_frames(patch) -> None:
    """Each forward computes the first half of its frames and repeats them."""
    from video_captioning_tpu_torch.models import backbones

    apply = backbones.apply_resnet50_folded

    def half(folded, images, **kwargs):
        n = max(1, images.shape[0] // 2)
        y = apply(folded, images[:n], **kwargs)
        return torch.cat([y, y])[: images.shape[0]]

    patch(backbones, "apply_resnet50_folded", half)


def answer_altered(patch) -> None:
    """Each forward's first frame comes out 1% off."""
    from video_captioning_tpu_torch.models import backbones

    apply = backbones.apply_resnet50_folded

    def altered(folded, images, **kwargs):
        y = apply(folded, images, **kwargs).clone()
        y[0] *= 1.01
        return y

    patch(backbones, "apply_resnet50_folded", altered)


class Patches:
    """``setattr`` that remembers, and ``undo`` that puts everything back."""

    def __init__(self):
        self.saved: List[Tuple[object, str, object]] = []

    def setattr(self, owner, name: str, value) -> None:
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)
