"""CNN frame-feature backbones: ``FeatureExtractor``.

Counterpart of video_captioning_tpu/models/backbones/__init__.py, with the
same constructor and errors and a ``device`` argument (the card by
default). Frames go to the device as uint8 and the /255 and ImageNet
mean/std step runs there, in the compute dtype, before the CNN. Variants:
VGG16 ``xla`` (and ``int8``); ResNet50 ``xla`` (the eval module), ``folded``
(BN folded), ``fused`` (folded, the 12 identity blocks through the
fused-bottleneck kernel), ``fused_s2d`` (the same with the space-to-depth
stem) and ``int8`` (W8A8, calibrated on the first batch or loaded from a
``vcw-int8-v1`` file; ``kernels.int8_conv1x1_pallas`` routes its 1x1 convs
through the int8 kernels).
"""

from __future__ import annotations

import functools
import logging
import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ...config import Config, KernelConfig
from ..weights import (
    backbone_state_dict_from_jax,
    init_backbone_params_numpy,
    load_backbone_state,
    tree_map,
)
from .resnet import ResNet50, apply_resnet50, apply_resnet50_folded, fold_bn
from .vgg import VGG16, apply_vgg16

logger = logging.getLogger(__name__)

FEATURE_DIMS = {"vgg16": 4096, "resnet50": 2048}

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _load_state_file(path: Path) -> Dict[str, np.ndarray]:
    path = Path(path)
    if path.suffix == ".npz":
        return dict(np.load(path))
    with open(path, "rb") as f:
        state = pickle.load(f)
    return {k: np.asarray(v) for k, v in state.items()}


class FeatureExtractor:
    """Batched on-device frame -> feature extraction."""

    def __init__(
        self,
        model_type: str = "vgg16",
        config: Optional[Config] = None,
        *,
        weights_path: Optional[Path] = None,
        batch_size: int = 32,
        seed: int = 0,
        allow_random_init: bool = False,
        variant: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        device: str = "cuda",
    ):
        model_type = model_type.lower()
        if model_type not in FEATURE_DIMS:
            raise ValueError(f"Unsupported model type: {model_type}")
        self.model_type = model_type
        self.feature_dim = FEATURE_DIMS[model_type]
        self.batch_size = batch_size
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # cuDNN convs default to TF32, which would break float32 parity.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        from ...cli.convert_weights import is_int8_native

        # A quantized (vcw-int8-v1) weights file implies variant="int8".
        if variant is None and weights_path is not None and is_int8_native(weights_path):
            variant = "int8"
        if variant is None:
            variant = ((config.kernels if config is not None else KernelConfig())
                       .resnet50_variant if model_type == "resnet50" else "xla")
        if model_type == "vgg16" and variant not in ("xla", "int8"):
            raise ValueError(f"VGG16 has no {variant!r} variant (no BN to fold)")
        if variant not in ("xla", "folded", "fused", "fused_s2d", "int8"):
            raise ValueError(f"Unknown resnet50 variant: {variant}")
        self.variant = variant
        if compute_dtype is None:
            compute_dtype = "float32"
        if compute_dtype not in _DTYPES:
            raise ValueError(f"Unknown compute_dtype: {compute_dtype}")
        self.compute_dtype = _DTYPES[compute_dtype]
        self._mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(_IMAGENET_STD, device=self.device)
        self._int8_calibrated = False
        self.model = None

        if weights_path is not None:
            from ...cli.convert_weights import is_native, load_int8_weights, load_native

            if is_int8_native(weights_path):
                # A calibrated W8A8 file: the quantized tree, no fp32 weights.
                if variant != "int8":
                    raise ValueError(
                        f"{weights_path} holds int8-quantized weights; "
                        "construct with variant='int8' to use them"
                    )
                loaded_type, qp = load_int8_weights(weights_path)
                if loaded_type != model_type:
                    raise ValueError(
                        f"{weights_path} holds {loaded_type} weights but "
                        f"{model_type} was requested"
                    )
                self._finalize_int8(qp)
                logger.info(f"Loaded quantized {model_type} weights from {weights_path}")
                return
            if is_native(weights_path):
                loaded_type, params = load_native(weights_path)
                if loaded_type != model_type:
                    raise ValueError(
                        f"{weights_path} holds {loaded_type} weights but "
                        f"{model_type} was requested"
                    )
                state = backbone_state_dict_from_jax(params, model_type)
            else:
                state = _load_state_file(weights_path)
            logger.info(f"Loaded {model_type} weights from {weights_path}")
        elif allow_random_init:
            state = backbone_state_dict_from_jax(
                init_backbone_params_numpy(model_type, seed), model_type)
            logger.warning(
                f"No pretrained weights supplied for {model_type}; using random "
                "init (fine for pipeline tests, not for caption quality)"
            )
        else:
            raise ValueError(
                f"No pretrained weights supplied for {model_type}. Convert a "
                "torchvision checkpoint with "
                "`python -m video_captioning_tpu_torch.cli.convert_weights` and pass "
                "weights_path, or opt into random init explicitly with "
                "allow_random_init=True (features will be meaningless for "
                "caption quality)."
            )

        model = VGG16() if model_type == "vgg16" else ResNet50()
        load_backbone_state(model, state)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        if variant == "int8":
            # Weights are quantized and activation scales calibrated on the
            # first extract() batch, or by calibrate_int8.
            self._folded = fold_bn(self.model) if model_type == "resnet50" else None
            self._apply = None
            return
        if model_type == "vgg16" or variant == "xla":
            run = self.model.to(self.compute_dtype)
            apply = functools.partial(apply_vgg16 if model_type == "vgg16" else apply_resnet50,
                                      run)
        else:
            apply = functools.partial(
                apply_resnet50_folded,
                tree_map(lambda t: t.to(self.compute_dtype), fold_bn(self.model)),
                use_pallas=variant in ("fused", "fused_s2d"), stem_s2d=variant == "fused_s2d")
        self._apply = apply

    def _normalize(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 -> /255 -> ImageNet mean/std, in the compute dtype."""
        dt = self.compute_dtype
        x = frames_u8.to(dt) / 255.0
        return (x - self._mean.to(dt)) / self._std.to(dt)

    def calibrate_int8(self, frames: np.ndarray) -> None:
        """Calibrate the int8 variant's activation scales on uint8 frames
        (representative serving data; a few hundred frames suffice)."""
        if self.model is None:
            raise ValueError(
                "this extractor was loaded from a quantized weights file "
                "and holds no fp32 weights; recalibration needs the "
                "original fp32 weights_path (re-run convert_weights "
                "--emit-int8 with new calibration frames instead)"
            )
        u8 = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        norm = (u8.float() / 255.0 - self._mean) / self._std
        if self.model_type == "resnet50":
            from .resnet_int8 import calibrate_resnet50_int8, quantize_resnet50_int8

            scales = calibrate_resnet50_int8(self._folded, norm, batch_size=self.batch_size)
            qp = quantize_resnet50_int8(self._folded, scales)
        else:
            from .vgg_int8 import calibrate_vgg16_int8, quantize_vgg16_int8

            scales = calibrate_vgg16_int8(self.model, norm, batch_size=self.batch_size)
            qp = quantize_vgg16_int8(self.model, scales)
        self._finalize_int8(tree_map(lambda t: t.numpy(), qp))

    def _finalize_int8(self, qp) -> None:
        """The int8 forward from a quantized tree in the JAX layout."""
        from .resnet_int8 import apply_resnet50_int8, int8_run_params
        from .vgg_int8 import apply_vgg16_int8

        self._qp = qp
        run = int8_run_params(qp, self.device)
        if self.model_type == "resnet50":
            k = self.config.kernels if self.config is not None else None
            self._apply = functools.partial(apply_resnet50_int8, run,
                                            use_pallas_1x1=bool(k and k.int8_conv1x1_pallas))
        else:
            self._apply = functools.partial(apply_vgg16_int8, run)
        self._int8_calibrated = True

    def save_int8(self, path) -> dict:
        """Persist the calibrated W8A8 tree (a ``vcw-int8-v1`` file, which
        either package loads with ``variant="int8", weights_path=path``)."""
        if not self._int8_calibrated:
            raise ValueError(
                "int8 extractor is not calibrated yet — extract a batch or "
                "call calibrate_int8(frames) first")
        from ...cli.convert_weights import save_int8_weights

        return save_int8_weights(path, self.model_type, self._qp)

    def traceable_fn(self):
        """``(N, H, W, 3) uint8 -> (N, F) float32`` with the weights held
        inside: the CNN stage of the full-pipeline export
        (``inference/export.py`` ``include_cnn``), traceable by
        ``torch.export``. The int8 variant must be calibrated already (a
        ``vcw-int8-v1`` weights file, or ``calibrate_int8``)."""
        if self.variant == "int8" and not self._int8_calibrated:
            raise ValueError("int8 extractor is not calibrated; load a vcw-int8-v1 weights "
                             "file or call calibrate_int8(frames) before tracing")
        apply, normalize = self._apply, self._normalize
        return lambda frames_u8: apply(normalize(frames_u8)).float()

    @torch.inference_mode()
    def extract_tensor(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """One batch already on the device: (N, H, W, 3) uint8 -> (N,
        feature_dim) float32 on the device."""
        return self._apply(self._normalize(frames_u8)).float()

    def extract(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB frames -> (N, feature_dim) float32."""
        if self.variant == "int8" and not self._int8_calibrated:
            self.calibrate_int8(frames[: max(self.batch_size, 1) * 4])
        outs = []
        for i in range(0, frames.shape[0], self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(frames[i:i + self.batch_size]))
            outs.append(self.extract_tensor(chunk.to(self.device)).cpu())
        return torch.cat(outs).numpy()

    def extract_video(self, frames: np.ndarray) -> np.ndarray:
        """Alias used by preprocess: (T, H, W, 3) -> (T, feature_dim)."""
        return self.extract(frames)


def create_feature_extractor(
    config: Config,
    model_type: str = "vgg16",
    weights_path: Optional[Path] = None,
    *,
    allow_random_init: bool = False,
    variant: Optional[str] = None,
    compute_dtype: Optional[str] = None,
    device: str = "cuda",
) -> FeatureExtractor:
    """Factory (same signature as the JAX package's, plus ``device``)."""
    return FeatureExtractor(model_type, config, weights_path=weights_path,
                            allow_random_init=allow_random_init, variant=variant,
                            compute_dtype=compute_dtype, device=device)
