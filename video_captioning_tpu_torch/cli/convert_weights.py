"""convert-weights CLI: torchvision CNN state dicts -> native weight files.

The port's own copy of video_captioning_tpu/cli/convert_weights.py. The
``vcw-v1`` / ``vcw-int8-v1`` checksummed ``.npz`` container is the same:
flattened ``path/to/leaf`` arrays of the JAX package's backbone pytree plus
``__format__`` / ``__model_type__`` markers and a JSON metadata entry
(source file, per-leaf sha256 digest), so files move between the two
packages in both directions. The pytree comes from the state dict through
the port's weight bridge (models/weights.py):

    python -m video_captioning_tpu_torch.cli.convert_weights \
        --input vgg16-397923af.pth --model-type vgg16 --output vgg16.vcw.npz

Input formats: ``.pth``/``.pt`` through ``torch.load``, ``.npz`` and pickled
dicts. ``--emit-int8`` calibrates on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
from pathlib import Path
from typing import Dict

import numpy as np

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)

NATIVE_FORMAT = "vcw-v1"
INT8_FORMAT = "vcw-int8-v1"

_EXPECTED_KEYS = {
    # spot keys proving the state dict is the advertised architecture
    "vgg16": ["features.0.weight", "classifier.3.bias"],
    "resnet50": ["conv1.weight", "layer4.2.bn3.running_var"],
}


def _load_any_state(path: Path) -> Dict[str, np.ndarray]:
    """Load a state dict from .pth/.pt (torch), .npz, or pickle."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        import torch

        state = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in state.items()}
    if path.suffix == ".npz":
        return dict(np.load(path))
    import pickle

    with open(path, "rb") as f:
        state = pickle.load(f)
    return {k: np.asarray(v) for k, v in state.items()}


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    """Inverse of :func:`_flatten` (dicts; integer keys become lists)."""
    root: Dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _save_checksummed_npz(output_path: Path, fmt: str, model_type: str,
                          tree, extra_meta: Dict = None) -> dict:
    """Shared checksummed-npz container writer (vcw-v1 / vcw-int8-v1)."""
    output_path = Path(output_path)
    if output_path.suffix != ".npz":
        raise ValueError(
            f"weights file must end in .npz — np.savez would silently "
            f"write {output_path}.npz and loaders would miss it: "
            f"{output_path}"
        )
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    digests = {k: hashlib.sha256(v.tobytes()).hexdigest()[:16]
               for k, v in flat.items()}
    meta = {
        "format": fmt,
        "model_type": model_type,
        "n_params": int(sum(v.size for v in flat.values())),
        "sha256": digests,
        **(extra_meta or {}),
    }
    np.savez(
        output_path,
        __format__=np.asarray(fmt),
        __model_type__=np.asarray(model_type),
        __meta__=np.asarray(json.dumps(meta)),
        **flat,
    )
    return meta


def _load_checksummed_npz(path: Path, fmt: str):
    """Shared verified loader: format marker, COMPLETE leaf set, and
    per-leaf sha256 digests must all match the recorded metadata."""
    data = dict(np.load(path))
    if "__format__" not in data or str(data["__format__"]) != fmt:
        raise ValueError(f"{path} is not a {fmt} weights file")
    model_type = str(data["__model_type__"])
    meta = json.loads(str(data["__meta__"]))
    flat = {k: v for k, v in data.items() if not k.startswith("__")}
    recorded = set(meta["sha256"])
    if set(flat) != recorded:
        missing = sorted(recorded - set(flat))[:3]
        extra = sorted(set(flat) - recorded)[:3]
        raise ValueError(
            f"{path}: leaf set does not match the recorded manifest "
            f"(missing e.g. {missing}, unexpected e.g. {extra})"
        )
    for k, v in flat.items():
        digest = hashlib.sha256(v.tobytes()).hexdigest()[:16]
        if meta["sha256"][k] != digest:
            raise ValueError(f"{path}: checksum mismatch for {k}")
    return model_type, _unflatten(flat)


def convert(input_path: Path, model_type: str, output_path: Path) -> dict:
    """torchvision state dict file -> native .vcw.npz; returns metadata."""
    from ..models.weights import jax_backbone_params_from_state_dict

    state = _load_any_state(input_path)
    for key in _EXPECTED_KEYS[model_type]:
        if key not in state:
            raise SystemExit(
                f"{input_path} does not look like a torchvision {model_type} "
                f"state dict (missing key {key!r}); found e.g. "
                f"{sorted(state)[:3]}"
            )
    params = jax_backbone_params_from_state_dict(state, model_type)
    meta = _save_checksummed_npz(output_path, NATIVE_FORMAT, model_type,
                                 params, {"source": str(input_path)})
    logger.info(
        f"Wrote {output_path}: {len(meta['sha256'])} arrays, "
        f"{meta['n_params']:,} parameters"
    )
    return meta


def load_native(path: Path):
    """Load a converted .vcw.npz -> (model_type, params pytree).

    Verifies the format marker, complete leaf set, and per-leaf sha256
    digests recorded at conversion time.
    """
    try:
        with np.load(path) as data:
            if ("__format__" in data.files
                    and str(np.asarray(data["__format__"])) == INT8_FORMAT):
                raise ValueError(
                    f"{path} holds QUANTIZED ({INT8_FORMAT}) weights — "
                    "construct the FeatureExtractor with variant='int8' to "
                    "load them"
                )
    except ValueError:
        raise
    except Exception:
        pass  # not an npz at all; the loader below raises the format error
    return _load_checksummed_npz(path, NATIVE_FORMAT)


def is_native(path: Path) -> bool:
    if Path(path).suffix != ".npz":
        return False
    try:
        with np.load(path) as data:
            return "__format__" in data.files
    except Exception:
        return False


def save_int8_weights(output_path: Path, model_type: str, qp) -> dict:
    """Persist a calibrated W8A8 tree (resnet_int8/vgg_int8 qp pytree) as a
    checksummed ``vcw-int8-v1`` .npz — calibrate ONCE offline, serve from
    the file (no per-process calibration batches)."""
    flat = _flatten(qp)
    int8_bytes = int(sum(np.asarray(v).nbytes for v in flat.values()
                         if np.asarray(v).dtype == np.int8))
    meta = _save_checksummed_npz(output_path, INT8_FORMAT, model_type, qp,
                                 {"int8_bytes": int8_bytes})
    logger.info(f"Wrote {output_path}: quantized {model_type}, "
                f"{int8_bytes:,} int8 bytes")
    return meta


def load_int8_weights(path: Path):
    """Load a ``vcw-int8-v1`` file -> (model_type, qp pytree), verifying
    the format marker, complete leaf set, and per-leaf digests."""
    return _load_checksummed_npz(path, INT8_FORMAT)


def is_int8_native(path: Path) -> bool:
    if Path(path).suffix != ".npz":
        return False
    try:
        with np.load(path) as data:
            if "__format__" not in data.files:
                return False
            return str(np.asarray(data["__format__"])) == INT8_FORMAT
    except Exception:
        return False


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Convert torchvision CNN weights to the native format")
    parser.add_argument("--input", type=str, required=True,
                        help="torchvision state dict (.pth/.pt/.npz/pickle)")
    parser.add_argument("--model-type", type=str, required=True,
                        choices=["vgg16", "resnet50"])
    parser.add_argument("--output", type=str, required=True,
                        help="Output native weights file (.npz)")
    parser.add_argument("--emit-int8", type=str, default=None,
                        help="Also emit a calibrated W8A8 int8 weights file "
                             "(vcw-int8-v1; serve with variant='int8' — "
                             "no per-process calibration)")
    parser.add_argument("--calib-frames", type=str, default=None,
                        help="Calibration frames for --emit-int8: a .npy of "
                             "(N, H, W, 3) uint8 RGB frames representative "
                             "of serving data")
    parser.add_argument("--calib-random", type=int, default=None,
                        help="Calibrate --emit-int8 on N random frames "
                             "instead (pipeline testing only; real "
                             "deployments should pass --calib-frames)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device that calibrates --emit-int8 (cuda or cpu)")
    parser.add_argument("--log-level", type=str, default="INFO")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    # Validate calibration flags BEFORE the (expensive) conversion so a
    # bad invocation fails fast.
    if args.emit_int8:
        if (args.calib_frames is None) == (args.calib_random is None):
            raise SystemExit(
                "--emit-int8 needs exactly one of --calib-frames / "
                "--calib-random")
        if args.calib_random is not None and args.calib_random < 1:
            raise SystemExit("--calib-random needs at least 1 frame")
    meta = convert(Path(args.input), args.model_type, Path(args.output))
    print(json.dumps({k: meta[k] for k in
                      ("format", "model_type", "n_params")}))
    if args.emit_int8:
        if args.calib_frames:
            frames = np.load(args.calib_frames)
            if frames.dtype != np.uint8 or frames.ndim != 4:
                raise SystemExit(
                    f"--calib-frames must be (N, H, W, 3) uint8; got "
                    f"{frames.dtype} {frames.shape}")
        else:
            logger.warning("Calibrating on RANDOM frames — fine for "
                           "pipeline tests, not for serving quality")
            frames = np.random.RandomState(0).randint(
                0, 256, (args.calib_random, 224, 224, 3), np.uint8)
        from ..models.backbones import FeatureExtractor

        fx = FeatureExtractor(args.model_type, weights_path=Path(args.output),
                              variant="int8", device=args.device)
        fx.calibrate_int8(frames)
        qmeta = fx.save_int8(Path(args.emit_int8))
        print(json.dumps({k: qmeta[k] for k in
                          ("format", "model_type", "int8_bytes")}))


if __name__ == "__main__":
    main()
