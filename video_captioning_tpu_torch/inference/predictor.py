"""Inference API: captions from features or from a video.

Counterpart of video_captioning_tpu/inference/predictor.py:
``VideoCaptionPredictor`` (load, power-of-two batch buckets,
``predict_from_features``, ``predict_batch``, ``predict_from_video``,
``generate_multiple_captions``, ``explain_prediction``; greedy, beam and
ancestral sampling) and ``BatchPredictor`` (videos in device batches, each
failing video an error entry in its place). It runs on the card unless the caller names
another device (``device="cpu"``); a CUDA device on a host without one
raises. Batches are zero-padded to the next power of two as in the JAX
package: the padded rows take part in the beam loop's batch-wide stop
condition, so the padding is part of the result's definition.

Video input decodes ``video_sequence_length`` frames (``data/video.py``,
OpenCV) and turns them into features in one of two modes:
``"pixel_stub"`` (the upstream predictor's flattened pixels, 224 x 224
frames, the default) or ``"cnn"`` (``models.backbones.FeatureExtractor`` on
the predictor's device: VGG16 for 4096-d models, ResNet50 in
``kernels.resnet50_variant`` for 2048-d ones, built once and kept).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config

from ..data import video as video_mod
from ..generation.beam import beam_search_generate
from ..generation.greedy import greedy_generate
from ..generation.sampling import sample_generate
from ..models.captioner import VideoCaptioningModel, apply_model, encode
from ..models.weights import state_dict_from_jax_params
from ..utils.checkpoint import load_model_for_inference, vocabulary_from_package
from .utils import resize_feature_sequence

METHODS = ("greedy", "beam", "sample")
FEATURE_MODES = ("pixel_stub", "cnn")
# The fused decode step's kernels take float32 operands only.
BF16_FUSED_NOT_PORTED = ("compute_dtype='bfloat16' with kernels.{} is not ported to "
                         "video_captioning_tpu_torch yet: the lstm_cell, bahdanau_attend and "
                         "vocab_topk_lse kernels take float32 operands (ROADMAP.md B, their "
                         "bfloat16 operand forms)")


def check_compute_dtype(config: Config, compute_dtype: Optional[str]) -> None:
    """Raise for a compute dtype the port does not serve with ``config``."""
    if compute_dtype in (None, "float32"):
        return
    if compute_dtype != "bfloat16":
        raise ValueError(f"compute_dtype {compute_dtype!r} is not float32 or bfloat16")
    if config.model.architecture == "transformer":
        raise NotImplementedError(
            "compute_dtype='bfloat16' for the transformer family is not ported to "
            "video_captioning_tpu_torch yet (ROADMAP.md A4, bfloat16 transformer serving)")
    k = config.kernels
    for flag in ("use_pallas_lstm", "use_pallas_attention", "use_fused_vocab_topk"):
        if getattr(k, flag):
            raise NotImplementedError(BF16_FUSED_NOT_PORTED.format(flag))


class VideoCaptionPredictor:
    """Generate captions with a trained inference package."""

    def __init__(
        self,
        model_path: Union[str, Path],
        config: Optional[Config] = None,
        device: Union[str, torch.device] = "cuda",
        compute_dtype: Optional[str] = None,
        decode_int8: str = "off",
        feature_mode: str = "pixel_stub",
        cnn_weights_path: Optional[Union[str, Path]] = None,
        allow_random_cnn_init: bool = False,
        sample_seed: int = 0,
        sample_top_k: int = 0,
    ):
        if feature_mode not in FEATURE_MODES:
            raise ValueError(f"feature_mode {feature_mode!r} is not one of {FEATURE_MODES}")
        if decode_int8 != "off":
            raise NotImplementedError("decode_int8 is not ported to video_captioning_tpu_torch yet")
        model_path = Path(model_path)
        if model_path.suffix == ".vcx":
            raise NotImplementedError(".vcx artifacts are not ported to video_captioning_tpu_torch yet")
        self.logger = logging.getLogger(__name__)
        self.device = torch.device(device)
        self.feature_mode = feature_mode
        self._cnn_weights_path = cnn_weights_path
        self._allow_random_cnn_init = allow_random_cnn_init
        self._backbone = None
        self.sample_seed = sample_seed
        self.sample_top_k = sample_top_k
        self._sample_generator: Optional[torch.Generator] = None
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r}: no CUDA device here; pass device='cpu'")
            # float32 products stay float32: only lstm_seq uses bf16 operands.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        package = load_model_for_inference(model_path)
        self.config = config if config is not None else Config.from_dict(package["model_config"])
        check_compute_dtype(self.config, compute_dtype)
        self.vocabulary = vocabulary_from_package(package, self.config)
        params = package["model_state_dict"]
        vocab_size = np.asarray(params["decoder"]["output_projection"]["kernel"]).shape[1]
        model = VideoCaptioningModel(self.config, vocab_size)
        model.load_state_dict(state_dict_from_jax_params(params, self.config))
        if compute_dtype == "bfloat16":
            model = model.to(torch.bfloat16)
        self.model = model.to(self.device).eval()
        self.logger.info(f"Loaded model with {len(self.vocabulary)} vocabulary size on {self.device}")

    @staticmethod
    def _bucket_size(n: int) -> int:
        """Next power of two >= n."""
        b = 1
        while b < n:
            b *= 2
        return b

    @torch.inference_mode()
    def _run_generation(
        self,
        features_batch: np.ndarray,
        method: str,
        max_length: int,
        beam_size: int,
        length_penalty: float,
        temperature: float,
    ) -> Dict[str, np.ndarray]:
        if method not in METHODS:
            raise ValueError(
                f"method {method!r} is not supported by video_captioning_tpu_torch "
                f"(ported: {', '.join(METHODS)})"
            )
        B = features_batch.shape[0]
        feats = torch.from_numpy(features_batch).to(self.device)
        bucket = self._bucket_size(B)
        if bucket != B:  # zero rows, padded on the device: no second host copy
            feats = torch.cat([feats, feats.new_zeros((bucket - B,) + feats.shape[1:])])
        config, vocab = self.config, self.vocabulary
        enc_outs, final, mask = encode(self.model, config, feats)
        if method == "greedy":
            out = greedy_generate(self.model, config, enc_outs, final, vocab.start_idx,
                                  vocab.end_idx, max_length, mask, temperature=temperature)
        elif method == "sample":
            if self._sample_generator is None:
                self._sample_generator = torch.Generator(device=self.device).manual_seed(
                    self.sample_seed)
            out = sample_generate(self.model, config, enc_outs, final, vocab.start_idx,
                                  vocab.end_idx, max_length, mask, temperature=temperature,
                                  top_k=int(self.sample_top_k),
                                  generator=self._sample_generator)
        else:
            out = beam_search_generate(self.model, config, enc_outs, final, vocab.start_idx,
                                       vocab.end_idx, max_length, mask, beam_size=beam_size,
                                       length_penalty=length_penalty)
        return {k: v[:B].cpu().numpy() for k, v in out.items()}

    def _prepare_features(self, video_features: np.ndarray) -> np.ndarray:
        return resize_feature_sequence(
            np.asarray(video_features, np.float32), self.config.model.video_sequence_length)

    def predict_from_features(
        self,
        video_features: np.ndarray,
        method: str = "greedy",
        max_length: int = 20,
        beam_size: int = 5,
        length_penalty: float = 1.0,
        temperature: float = 1.0,
    ) -> Dict[str, Union[str, List[int], np.ndarray]]:
        features = self._prepare_features(video_features)[None]
        outputs = self._run_generation(features, method, max_length, beam_size,
                                       length_penalty, temperature)
        tokens = outputs["generated_tokens"][0].tolist()
        result = {
            "caption": self.vocabulary.decode_caption(tokens, remove_special_tokens=True),
            "tokens": tokens,
            "method": method,
        }
        if "logprobs" in outputs:
            result["logprob"] = float(outputs["logprobs"][0])
        if "attention_weights" in outputs:
            result["attention_weights"] = outputs["attention_weights"][0]
        return result

    def predict_batch(
        self,
        video_features_list: List[np.ndarray],
        method: str = "greedy",
        max_length: int = 20,
        beam_size: int = 5,
        length_penalty: float = 1.0,
        temperature: float = 1.0,
    ) -> List[Dict[str, Union[str, List[int]]]]:
        """One generation call for all clips."""
        if not video_features_list:
            return []
        batch = np.stack([self._prepare_features(f) for f in video_features_list])
        outputs = self._run_generation(batch, method, max_length, beam_size,
                                       length_penalty, temperature)
        return [
            {
                "caption": self.vocabulary.decode_caption(tokens.tolist()),
                "tokens": tokens.tolist(),
                "method": method,
            }
            for tokens in outputs["generated_tokens"]
        ]

    def predict_from_video(
        self,
        video_path: Union[str, Path],
        method: str = "greedy",
        max_length: int = 20,
        beam_size: int = 5,
        length_penalty: float = 1.0,
        temperature: float = 1.0,
        extract_features: bool = True,
    ) -> Dict[str, Union[str, List[int], np.ndarray]]:
        """Caption a video file; with ``extract_features=False`` read the
        features from the ``.npy`` beside it instead."""
        video_path = Path(video_path)
        if extract_features:
            features = self._extract_video_features(video_path)
        else:
            feature_path = video_path.with_suffix(".npy")
            if not feature_path.exists():
                raise FileNotFoundError(f"Feature file not found: {feature_path}")
            features = np.load(feature_path)
        result = self.predict_from_features(features, method=method, max_length=max_length,
                                            beam_size=beam_size, length_penalty=length_penalty,
                                            temperature=temperature)
        result["video_path"] = str(video_path)
        return result

    def _extract_video_features(self, video_path: Path) -> np.ndarray:
        """(video_sequence_length, cnn_feature_dim) float32 features of a
        video in the predictor's ``feature_mode``."""
        num_frames = self.config.model.video_sequence_length
        if self.feature_mode == "cnn":
            return self._cnn_features(video_path, num_frames)
        frames = video_mod.extract_frames(video_path, num_frames, resize=(224, 224),
                                          pad_mode="zero")
        return video_mod.pixel_stub_features(frames, self.config.model.cnn_feature_dim)

    def _cnn_features(self, video_path: Path, num_frames: int) -> np.ndarray:
        from ..models.backbones import FeatureExtractor

        if self._backbone is None:
            model_type = "vgg16" if self.config.model.cnn_feature_dim == 4096 else "resnet50"
            self._backbone = FeatureExtractor(
                model_type, self.config, weights_path=self._cnn_weights_path,
                allow_random_init=self._allow_random_cnn_init, device=str(self.device))
        frames = video_mod.extract_frames(video_path, num_frames,
                                          resize=tuple(self.config.data.img_size),
                                          pad_mode="zero")
        return self._backbone.extract(frames)

    def generate_multiple_captions(
        self,
        video_features: np.ndarray,
        num_captions: int = 5,
        method: str = "beam",
        max_length: int = 20,
        beam_size: int = 10,
        temperature: float = 1.0,
    ) -> List[Dict[str, Union[str, float, List[int]]]]:
        """``num_captions`` captions of one clip: with ``method="beam"`` the
        top hypotheses of one beam search by score (``beam_size`` raised to
        ``num_captions`` where smaller); with ``"sample"`` that many draws,
        scored by their log-probability and sorted best first; otherwise
        greedy decodes at temperatures from 0.7 to 1.3, scored 1 /
        temperature."""
        captions: List[Dict[str, Union[str, float, List[int]]]] = []
        if method == "beam":
            beam_size = max(beam_size, num_captions)
            features = self._prepare_features(video_features)[None]
            outputs = self._run_generation(features, "beam", max_length, beam_size, 1.0,
                                           temperature)
            all_tokens, all_scores = outputs["all_tokens"][0], outputs["all_scores"][0]
            for rank in np.argsort(-all_scores)[:num_captions]:
                tokens = all_tokens[rank].tolist()
                captions.append({"caption": self.vocabulary.decode_caption(tokens),
                                 "score": float(all_scores[rank]), "tokens": tokens})
            return captions
        if method == "sample":
            for _ in range(num_captions):
                result = self.predict_from_features(video_features, method="sample",
                                                    max_length=max_length, temperature=temperature)
                captions.append({"caption": result["caption"],
                                 "score": result.get("logprob", 0.0), "tokens": result["tokens"]})
            captions.sort(key=lambda c: -c["score"])
            return captions
        for temp in np.linspace(0.7, 1.3, num_captions):
            result = self.predict_from_features(video_features, method="greedy",
                                                max_length=max_length, temperature=float(temp))
            captions.append({"caption": result["caption"], "score": 1.0 / float(temp),
                             "tokens": result["tokens"], "temperature": float(temp)})
        return captions

    @torch.inference_mode()
    def explain_prediction(self, video_features: np.ndarray,
                           caption_tokens: List[int]) -> Dict[str, Union[np.ndarray, int]]:
        """The teacher-forced pass of one clip over ``caption_tokens``: the
        attention weights (1, T, S) and encoder outputs (1, S, H)."""
        features = self._prepare_features(video_features)[None]
        feats = torch.from_numpy(features).to(self.device)
        tokens = torch.tensor([list(caption_tokens[:-1])], dtype=torch.int64, device=self.device)
        out = apply_model(self.model, self.config, feats, tokens, train=False)
        weights = out["attention_weights"]
        return {
            "attention_weights": None if weights is None else weights.cpu().numpy(),
            "encoder_outputs": out["encoder_outputs"].cpu().numpy(),
            "video_length": int(features.shape[1]),
            "caption_length": len(caption_tokens),
        }


class BatchPredictor:
    """Captions many videos, ``batch_size`` of them in each device batch;
    a video that fails to decode becomes an error entry in its place."""

    def __init__(self, predictor: VideoCaptionPredictor, batch_size: int = 8):
        self.predictor = predictor
        self.batch_size = batch_size
        self.logger = logging.getLogger(__name__)

    def predict_videos(self, video_paths: List[Union[str, Path]], method: str = "greedy",
                       max_length: int = 20, **kwargs) -> List[Dict[str, Union[str, List[int]]]]:
        results: List[Dict[str, Union[str, List[int]]]] = []
        num_chunks = -(-len(video_paths) // self.batch_size)
        for chunk_idx in range(num_chunks):
            chunk = video_paths[chunk_idx * self.batch_size:(chunk_idx + 1) * self.batch_size]
            self.logger.info(f"Processing batch {chunk_idx + 1}/{num_chunks}")
            features, ok_paths, errors = [], [], {}
            for path in chunk:
                try:
                    features.append(self.predictor._extract_video_features(Path(path)))
                    ok_paths.append(str(path))
                except Exception as e:
                    self.logger.error(f"Error processing {path}: {e}")
                    errors[str(path)] = str(e)
            batch_results = (self.predictor.predict_batch(features, method=method,
                                                          max_length=max_length, **kwargs)
                             if features else [])
            by_path = dict(zip(ok_paths, batch_results))
            for path in chunk:
                r = by_path.get(str(path))
                if r is None:
                    r = {"video_path": str(path), "caption": "",
                         "error": errors.get(str(path), "unknown error")}
                else:
                    r["video_path"] = str(path)
                results.append(r)
        return results
