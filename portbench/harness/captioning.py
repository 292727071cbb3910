"""Set-up and check shared by drivers that caption: weights from the seed,
the inference package written under TMPDIR and loaded by the program's
predictor, a pool of host feature clips, and the reference's judgement of a
sample of what was served."""

from __future__ import annotations

import tempfile
from typing import Dict, List

import numpy as np
import torch

from . import inputs
from .loop import program_config, reference_precision, spanned
from .trace import span


class Captioning:
    """The predictor set up from the seed, every bucket size the mix sends
    warmed up (``warm_batches``), and each call's beam scores kept beside
    its tokens."""

    def __init__(self, config: dict, mix: dict, seed: int, device: str, trace: bool):
        from video_captioning_tpu_torch.data.vocabulary import Vocabulary
        from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
        from video_captioning_tpu_torch.utils.checkpoint import save_model_for_inference

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        m = config["model"]
        conf = program_config(config)
        self.weights = inputs.captioner_weights(config, seed, device)
        vocab = Vocabulary(conf)
        for i in range(len(vocab), m["vocab_size"]):
            vocab.word2idx[f"w{i}"] = i
            vocab.idx2word[i] = f"w{i}"
        self.start, self.end = vocab.start_idx, vocab.end_idx
        w = config["weights"]
        if (self.start, self.end) != (int(w["start_idx"]), int(w["end_idx"])):
            raise ValueError(f"the vocabulary's START / END {self.start} / {self.end} are not "
                             f"the configuration's {w['start_idx']} / {w['end_idx']}")
        with tempfile.TemporaryDirectory() as tmp:
            pkg = save_model_for_inference(inputs.to_numpy(self.weights), vocab, conf, tmp)
            self.predictor = VideoCaptionPredictor(pkg, device=device)
        self.options = {"method": mix["method"], "max_length": mix["max_length"],
                        "beam_size": mix["beam_size"],
                        "length_penalty": mix.get("length_penalty", 1.0)}
        self.pool = inputs.feature_pool(mix["pool"], m["video_sequence_length"],
                                        m["cnn_feature_dim"], seed, device)
        self._spy(trace)
        self.warm()
        if device != "cpu":
            torch.cuda.synchronize()

    def warm(self) -> None:
        """Two calls at each bucket size the mix sends."""
        for b in self.mix["warm_batches"]:
            for _ in range(2):
                self.predict([self.pool[i] for i in range(b)])

    def _spy(self, trace: bool) -> None:
        """Keep each call's beam scores beside its tokens (``predict_batch``
        returns tokens only) and, in a traced run, record spans around the
        predictor's calls into the model and the beam search."""
        pred = self.predictor
        generate, predict_batch = pred._run_generation, pred.predict_batch
        last: Dict = {}

        def run_generation(*args, **kwargs):
            with span("pb.generate"):
                last["out"] = generate(*args, **kwargs)
            return last["out"]

        def predict(feats, **options):
            with span("pb.predict_batch"):
                results = predict_batch(feats, **options)
            for res, score in zip(results, served_scores(last["out"])):
                res["bench_score"] = float(score)
            return results

        pred._run_generation = run_generation
        pred.predict_batch = predict
        if trace:
            from video_captioning_tpu_torch.inference import predictor as module

            for name in ("encode", "beam_search_generate"):
                setattr(module, name, spanned(f"pb.{name}", getattr(module, name)))

    def predict(self, feats: list) -> list:
        return self.predictor.predict_batch(feats, **self.options)

    def free(self) -> None:
        self.predictor = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check_sample(self, clip_ids, tokens, scores) -> Dict[str, float]:
        """The reference's judgement of the served tokens and scores of the
        sampled requests, in blocks of ``check_block`` clips: the worst of
        each number over the sample."""
        worst: Dict[str, float] = {}
        step = self.mix.get("check_block", 32)
        with reference_precision(tf32=False), torch.no_grad():
            for i in range(0, len(clip_ids), step):
                feats = torch.from_numpy(self.pool[clip_ids[i:i + step]]).to(self.device)
                got = judge(self.config, self.mix, self.weights, feats,
                            torch.as_tensor(np.asarray(tokens[i:i + step]), dtype=torch.int64,
                                            device=self.device),
                            torch.as_tensor(np.asarray(scores[i:i + step]),
                                            dtype=torch.float32, device=self.device))
                for k, v in got.items():
                    worst[k] = max(worst.get(k, -np.inf), float(v.max()))
        return worst


def judge(config: dict, mix: dict, weights: dict, feats, tokens, scores) -> Dict:
    """The reference's numbers for what was served for clips ``feats``."""
    from portbench.reference import captioner

    w = config["weights"]
    return captioner.judge(config, weights, feats, tokens, scores, mix["beam_size"],
                           mix["max_length"], int(w["start_idx"]), int(w["end_idx"]),
                           mix.get("length_penalty", 1.0))


def served_scores(out: Dict[str, np.ndarray]) -> np.ndarray:
    """The beam score of each clip's served sequence: the entry of
    ``all_scores`` whose hypothesis in ``all_tokens`` is the one served."""
    match = (out["all_tokens"] == out["generated_tokens"][:, None, :]).all(axis=-1)
    return out["all_scores"][np.arange(match.shape[0]), match.argmax(axis=1)]


def sample(seed: int, served: List[tuple], k: int):
    """``k`` of the served requests, drawn from the seed: (clip ids,
    tokens, scores)."""
    pick = inputs.sample_indices(seed, len(served), k)
    return ([served[j][0] for j in pick], [served[j][1] for j in pick],
            [served[j][2] for j in pick])


def caption_control(config: dict, mix: dict, seed: int, device: str) -> Dict[str, float]:
    """The control: the reference's own beam search in TF32 put in the
    program's place, on the clips a run's check samples, judged as a run."""
    from portbench.reference import captioner

    m, w = config["model"], config["weights"]
    weights = inputs.captioner_weights(config, seed, device)
    pool = inputs.feature_pool(mix["pool"], m["video_sequence_length"], m["cnn_feature_dim"],
                               seed, device)
    clips = inputs.sample_indices(seed, mix["pool"], mix["check_clips"])
    feats = torch.from_numpy(pool[clips]).to(device)
    with torch.no_grad():
        with reference_precision(tf32=True):
            tokens, scores = captioner.serve(config, weights, feats, mix["beam_size"],
                                             mix["max_length"], int(w["start_idx"]),
                                             int(w["end_idx"]), mix.get("length_penalty", 1.0))
        with reference_precision(tf32=False):
            got = judge(config, mix, weights, feats, tokens, scores)
    return {k: float(v.max()) for k, v in got.items()}
