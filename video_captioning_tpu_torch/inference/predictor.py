"""Inference API: captions from precomputed features.

Counterpart of video_captioning_tpu/inference/predictor.py
(VideoCaptionPredictor: load, power-of-two batch buckets,
predict_from_features, predict_batch, greedy and beam). It runs on the
card unless the caller names another device (``device="cpu"``). Batches
are zero-padded to the next power of two as in the JAX package: the
padded rows take part in the beam loop's batch-wide stop condition, so
the padding is part of the result's definition.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config

from ..generation.beam import beam_search_generate
from ..generation.greedy import greedy_generate
from ..models.captioner import VideoCaptioningModel, encode
from ..models.weights import state_dict_from_jax_params
from ..utils.checkpoint import load_model_for_inference, vocabulary_from_package
from .utils import resize_feature_sequence

METHODS = ("greedy", "beam")


class VideoCaptionPredictor:
    """Generate captions with a trained inference package."""

    def __init__(
        self,
        model_path: Union[str, Path],
        config: Optional[Config] = None,
        device: Union[str, torch.device] = "cuda",
        compute_dtype: Optional[str] = None,
        decode_int8: str = "off",
    ):
        if compute_dtype not in (None, "float32"):
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r} is not ported to video_captioning_tpu_torch yet")
        if decode_int8 != "off":
            raise NotImplementedError("decode_int8 is not ported to video_captioning_tpu_torch yet")
        model_path = Path(model_path)
        if model_path.suffix == ".vcx":
            raise NotImplementedError(".vcx artifacts are not ported to video_captioning_tpu_torch yet")
        self.logger = logging.getLogger(__name__)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # float32 products stay float32: only lstm_seq uses bf16 operands.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        package = load_model_for_inference(model_path)
        self.config = config if config is not None else Config.from_dict(package["model_config"])
        self.vocabulary = vocabulary_from_package(package, self.config)
        params = package["model_state_dict"]
        vocab_size = np.asarray(params["decoder"]["output_projection"]["kernel"]).shape[1]
        model = VideoCaptioningModel(self.config, vocab_size)
        model.load_state_dict(state_dict_from_jax_params(params, self.config))
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
