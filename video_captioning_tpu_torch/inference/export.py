"""Serving artifacts (``.vcx``) of ``torch.export`` programs.

Counterpart of video_captioning_tpu/inference/export.py
(``export_serving_artifact``, ``ExportedPredictor``). The JAX artifact
holds StableHLO; this one holds one ``torch.export`` program per batch
bucket and platform, each the predictor's exact serving function (encode,
then beam or greedy search) traced once with the weights inside it, so a
serving host needs no model code and no weight file. The serving kernels
are ``vct::`` custom ops in the program (``ops/library.py``): on the card
they launch the kernels (and count their launches), on the CPU the plain
versions.

Artifact (a zip):

* ``manifest.json``: the JAX manifest's keys (generation settings, batch
  buckets, platforms, vocabulary, model config, one sha256 a program,
  checked at load) with ``format`` ``"vcx-torch-v1"``;
* ``program_b{B}_{platform}.pt2``: a ``torch.export.save`` of bucket B's
  program for ``platform`` (``cpu`` or ``cuda``: a program holds its
  device); with ``include_cnn``, ``program_frames_b{B}_{platform}.pt2``
  too, uint8 frames -> normalization -> CNN backbone -> the same decode.

Ragged batches pad to the next bucket and larger ones chunk over the
largest, as in the JAX package. A JAX-written ``.vcx`` (format
``"vcx-v1"``) is refused with an error that names it; the JAX loader
refuses this format likewise. ``ExportedPredictor`` imports the op
registration and no model code: the vocabulary comes from the manifest.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

ARTIFACT_FORMAT = "vcx-torch-v1"
JAX_ARTIFACT_FORMAT = "vcx-v1"
PLATFORMS = ("cpu", "cuda")

logger = logging.getLogger(__name__)


def _sha256(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


class _ServingProgram(torch.nn.Module):
    """features (B, T, F) in the artifact's compute dtype -> the decode's
    outputs."""

    def __init__(self, model, config, start: int, end: int, method: str, max_length: int,
                 beam_size: int, length_penalty: float):
        super().__init__()
        self.model, self.config = model, config
        self.start, self.end, self.method = start, end, method
        self.max_length, self.beam_size, self.length_penalty = (max_length, beam_size,
                                                                length_penalty)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        from ..generation.beam import beam_search_generate
        from ..generation.greedy import greedy_generate
        from ..models.captioner import encode

        enc, final, mask = encode(self.model, self.config, features)
        if self.method == "beam":
            out = beam_search_generate(self.model, self.config, enc, final, self.start,
                                       self.end, self.max_length, mask,
                                       beam_size=self.beam_size,
                                       length_penalty=self.length_penalty)
            return {k: out[k] for k in ("generated_tokens", "all_tokens", "all_scores")}
        out = greedy_generate(self.model, self.config, enc, final, self.start, self.end,
                              self.max_length, mask)
        return {"generated_tokens": out["generated_tokens"]}


class _FramesProgram(torch.nn.Module):
    """uint8 frames (B, T, H, W, 3) -> CNN features in chunks of
    ``cnn_chunk`` frames, cast to ``feature_dtype`` -> the serving
    program."""

    def __init__(self, serving: _ServingProgram, cnn_fn, feature_dim: int, cnn_chunk: int,
                 feature_dtype: torch.dtype):
        super().__init__()
        self.serving, self.cnn_fn = serving, cnn_fn
        self.feature_dim, self.cnn_chunk = feature_dim, cnn_chunk
        self.feature_dtype = feature_dtype

    def forward(self, frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, T = frames_u8.shape[:2]
        flat = frames_u8.reshape((B * T,) + tuple(frames_u8.shape[2:]))
        feats = torch.cat([self.cnn_fn(flat[i:i + self.cnn_chunk])
                           for i in range(0, B * T, self.cnn_chunk)])
        return self.serving(feats.reshape(B, T, self.feature_dim).to(self.feature_dtype))


def _export_bytes(module: torch.nn.Module, example: torch.Tensor) -> bytes:
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_serving_artifact(
    model_path: Union[str, Path],
    output_path: Union[str, Path],
    batch_sizes: Sequence[int] = (1, 8, 64),
    method: str = "beam",
    max_length: int = 20,
    beam_size: int = 5,
    length_penalty: float = 1.0,
    compute_dtype: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
    include_cnn: bool = False,
    cnn_weights_path: Optional[Union[str, Path]] = None,
    cnn_model_type: Optional[str] = None,
    cnn_variant: Optional[str] = None,
    allow_random_cnn_init: bool = False,
    frame_batch_sizes: Optional[Sequence[int]] = None,
    cnn_chunk: int = 320,
    config=None,
) -> Path:
    """Trace and save the serving program of each batch bucket for each
    platform (default: ``cuda``, the card): the live predictor's model,
    loaded once a platform (``compute_dtype`` and all), under
    ``torch.export`` with features in the compute dtype (bfloat16 features
    for a bfloat16 artifact, as the JAX artifact casts them).
    ``include_cnn`` adds the frames programs over
    ``FeatureExtractor.traceable_fn`` (the backbone chosen by the model's
    feature width, or ``cnn_model_type``). ``config`` overrides the
    package's configuration, as the predictor's does."""
    from ..inference.predictor import VideoCaptionPredictor

    if method not in ("beam", "greedy"):
        raise ValueError(f"export supports deterministic methods beam/greedy, got {method!r}")
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    platforms = list(platforms) if platforms else ["cuda"]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {bad}")
    model_path = Path(model_path)
    frame_buckets = sorted(set(int(b) for b in (frame_batch_sizes or batch_sizes)))
    if include_cnn and (not frame_buckets or frame_buckets[0] < 1):
        raise ValueError(f"frame_batch_sizes must be positive, got {frame_buckets}")

    feature_dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    programs: Dict[str, bytes] = {}
    frame_programs: Dict[str, bytes] = {}
    cnn_meta = None
    for platform in platforms:
        pred = VideoCaptionPredictor(model_path, config=config, device=platform,
                                     compute_dtype=compute_dtype)
        cfg, vocab = pred.config, pred.vocabulary
        T, F = cfg.model.video_sequence_length, cfg.model.cnn_feature_dim
        serving = _ServingProgram(pred.model, cfg, vocab.start_idx, vocab.end_idx, method,
                                  max_length, beam_size, length_penalty).eval()
        for B in batch_sizes:
            key = f"{B}_{platform}"
            programs[key] = _export_bytes(
                serving, torch.zeros((B, T, F), dtype=feature_dtype, device=platform))
            logger.info(f"exported batch-{B} {platform} program: "
                        f"{len(programs[key]) / 2**20:.1f} MiB")
        if include_cnn:
            from ..models.backbones import FEATURE_DIMS, FeatureExtractor

            model_type = cnn_model_type or ("vgg16" if F == FEATURE_DIMS["vgg16"]
                                            else "resnet50")
            if FEATURE_DIMS.get(model_type) != F:
                raise ValueError(f"model expects {F}-d features but backbone {model_type} "
                                 f"produces {FEATURE_DIMS.get(model_type)}-d")
            extractor = FeatureExtractor(
                model_type, cfg, weights_path=Path(cnn_weights_path) if cnn_weights_path
                else None, variant=cnn_variant, allow_random_init=allow_random_cnn_init,
                compute_dtype=compute_dtype if compute_dtype in (None, "float32", "bfloat16")
                else None, device=platform)
            H, W = (int(s) for s in cfg.data.img_size)
            frames = _FramesProgram(serving, extractor.traceable_fn(), F, int(cnn_chunk),
                                    feature_dtype).eval()
            for B in frame_buckets:
                key = f"{B}_{platform}"
                frame_programs[key] = _export_bytes(
                    frames, torch.zeros((B, T, H, W, 3), dtype=torch.uint8, device=platform))
                logger.info(f"exported frames batch-{B} {platform} program: "
                            f"{len(frame_programs[key]) / 2**20:.1f} MiB")
            cnn_meta = {"model_type": model_type, "variant": extractor.variant,
                        "frame_shape": [T, H, W, 3], "frame_batch_sizes": frame_buckets,
                        "cnn_chunk": int(cnn_chunk),
                        "weights_source": str(cnn_weights_path) if cnn_weights_path
                        else ("random_init" if allow_random_cnn_init else None)}

    def table(blobs, stem):
        return {key: {"file": f"{stem}_b{key}.pt2", "sha256": _sha256(blob)}
                for key, blob in blobs.items()}

    manifest = {
        "format": ARTIFACT_FORMAT,
        "source_model": model_path.name,
        "method": method,
        "max_length": max_length,
        "beam_size": beam_size,
        "length_penalty": length_penalty,
        "compute_dtype": compute_dtype or "float32",
        "feature_shape": [T, F],
        "batch_sizes": batch_sizes,
        "platforms": platforms,
        "torch_version": torch.__version__,
        "programs": table(programs, "program"),
        "cnn": cnn_meta,
        "frame_programs": table(frame_programs, "program_frames"),
        "vocabulary": {
            "idx2word": {str(k): v for k, v in vocab.idx2word.items()},
            "special_tokens": {"pad_idx": vocab.pad_idx, "start_idx": vocab.start_idx,
                               "end_idx": vocab.end_idx, "unk_idx": vocab.unk_idx},
        },
        "model_config": cfg.to_dict(),
    }
    output_path = Path(output_path)
    tmp = output_path.with_suffix(output_path.suffix + ".tmp")
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=2))
        for blobs, entries in ((programs, manifest["programs"]),
                               (frame_programs, manifest["frame_programs"])):
            for key, blob in blobs.items():
                zf.writestr(zipfile.ZipInfo(entries[key]["file"]), blob,
                            compress_type=zipfile.ZIP_STORED)
    tmp.replace(output_path)
    logger.info(f"wrote serving artifact {output_path}")
    return output_path


class ExportedPredictor:
    """Serve captions from a port ``.vcx`` artifact, with no model code:
    the programs of ``device``'s platform (the card unless the caller asks
    for the CPU), tokens decoded through the manifest's vocabulary."""

    def __init__(self, artifact_path: Union[str, Path], device: Union[str, torch.device] = "cuda"):
        from .. import ops  # noqa: F401  (registers the vct:: custom ops)

        self.path = Path(artifact_path)
        with zipfile.ZipFile(self.path) as zf:
            manifest = json.loads(zf.read("manifest.json"))
        fmt = manifest.get("format")
        if fmt == JAX_ARTIFACT_FORMAT:
            raise ValueError(
                f"{self.path} is a {fmt!r} artifact written by the JAX package (StableHLO "
                f"programs), which PyTorch cannot run; export the .pth package with "
                f"video_captioning_tpu_torch.cli.export for a {ARTIFACT_FORMAT!r} artifact")
        if fmt != ARTIFACT_FORMAT:
            raise ValueError(f"{self.path} is not a {ARTIFACT_FORMAT} artifact (format={fmt!r})")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: no CUDA device here; pass device='cpu'")
        self.platform = self.device.type
        if self.platform not in manifest["platforms"]:
            raise ValueError(f"{self.path} holds programs for {manifest['platforms']}, "
                             f"not {self.platform} (re-export with --platforms "
                             f"{self.platform})")
        self.manifest = manifest
        self.method = manifest["method"]
        self.batch_sizes: List[int] = sorted(manifest["batch_sizes"])
        self._idx2word = {int(k): v for k, v in manifest["vocabulary"]["idx2word"].items()}
        sp = manifest["vocabulary"]["special_tokens"]
        # PAD/START/END are stripped, UNK kept, and END does not stop the
        # decode (Vocabulary.decode_caption's order).
        self._special = {sp["pad_idx"], sp["start_idx"], sp["end_idx"]}
        self._fns: Dict[tuple, object] = {}

    # ----------------------------------------------------- server surface

    @property
    def feature_dim(self) -> int:
        return int(self.manifest["feature_shape"][1])

    @property
    def generation_defaults(self) -> Dict[str, object]:
        """The baked generation options: the server's request defaults."""
        m = self.manifest
        return {"method": m["method"], "max_length": m["max_length"],
                "beam_size": m["beam_size"], "length_penalty": m["length_penalty"],
                "temperature": 1.0}

    def validate_options(self, options: Dict[str, object]) -> None:
        """Raise ValueError for options the baked program cannot honour."""
        baked = self.generation_defaults
        method = options.get("method", baked["method"])
        if method != baked["method"]:
            raise ValueError(f"artifact was exported with method={baked['method']!r}; "
                             f"cannot serve method={method!r} (re-export to change it)")

        def as_float(key, value):
            try:
                return float(value)
            except (TypeError, ValueError):
                raise ValueError(f"option {key}={value!r} is not a number") from None

        relevant = ["max_length"] + (["beam_size", "length_penalty"] if method == "beam"
                                     else [])
        for key in relevant:
            if key in options and as_float(key, options[key]) != float(baked[key]):
                raise ValueError(f"artifact was exported with {key}={baked[key]}; cannot "
                                 f"serve {key}={options[key]} (re-export to change it)")
        if "temperature" in options and as_float("temperature", options["temperature"]) != 1.0:
            raise ValueError("exported programs are deterministic (beam/greedy); "
                             "temperature is not supported")

    # ------------------------------------------------------------ loading

    def _load_program(self, table: str, bucket: int):
        key = (table, bucket)
        if key not in self._fns:
            entry = self.manifest[table][f"{bucket}_{self.platform}"]
            with zipfile.ZipFile(self.path) as zf:
                blob = zf.read(entry["file"])
            digest = _sha256(blob)
            if digest != entry["sha256"]:
                raise ValueError(f"{self.path}:{entry['file']} checksum mismatch (manifest "
                                 f"{entry['sha256'][:12]}…, file {digest[:12]}…) — artifact "
                                 "corrupted or tampered")
            self._fns[key] = torch.export.load(io.BytesIO(blob)).module()
        return self._fns[key]

    @staticmethod
    def _bucket_in(buckets: List[int], n: int) -> int:
        for b in buckets:
            if b >= n:
                return b
        return buckets[-1]

    # --------------------------------------------------------- generation

    def decode_caption(self, tokens: Sequence[int]) -> str:
        words = []
        for t in tokens:
            t = int(t)
            if t in self._idx2word and t not in self._special:
                words.append(self._idx2word[t])
        return " ".join(words)

    def _run(self, table: str, buckets: List[int], batch: np.ndarray) -> List[Dict[str, object]]:
        # A bfloat16 artifact's features go in as bfloat16, as the JAX
        # ExportedPredictor casts them (cast on the host: half the copy).
        cast = table == "programs" and self.manifest["compute_dtype"] == "bfloat16"
        results: List[Dict[str, object]] = []
        n, pos = batch.shape[0], 0
        while pos < n:
            chunk = batch[pos: pos + self._bucket_in(buckets, n - pos)]
            bucket = self._bucket_in(buckets, chunk.shape[0])
            real = chunk.shape[0]
            if real < bucket:
                pad = np.zeros((bucket - real,) + tuple(chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            inputs = torch.from_numpy(chunk)
            if cast:
                inputs = inputs.to(torch.bfloat16)
            with torch.inference_mode():
                out = self._load_program(table, bucket)(inputs.to(self.device))
            results.extend(self._records(out, real))
            pos += real
        return results

    def predict_batch(self, features, **options) -> List[Dict[str, object]]:
        """features: (B, T, F) resampled features, or a list of per-clip
        (frames_i, F) arrays (uniform-sampled or zero-padded to T as the
        live predictor does). Options must match the baked program."""
        from .utils import resize_feature_sequence

        if options:
            self.validate_options(options)
        T, F = self.manifest["feature_shape"]
        if isinstance(features, (list, tuple)):
            prepared = []
            for i, clip in enumerate(features):
                clip = np.asarray(clip, np.float32)
                if clip.ndim != 2 or clip.shape[1] != F:
                    raise ValueError(f"clip {i}: expected (frames, {F}) features, got shape "
                                     f"{clip.shape}")
                prepared.append(resize_feature_sequence(clip, T))
            features = np.stack(prepared) if prepared else np.zeros((0, T, F), np.float32)
        feats = np.asarray(features, np.float32)
        if feats.ndim != 3:
            raise ValueError(f"expected (B, T, F) features, got {feats.shape}")
        if list(feats.shape[1:]) != [T, F]:
            raise ValueError(f"expected features shaped (B, {T}, {F}), got {feats.shape}")
        return self._run("programs", self.batch_sizes, feats)

    def predict_from_features(self, video_features: np.ndarray) -> Dict[str, object]:
        return self.predict_batch(np.asarray(video_features)[None])[0]

    @property
    def includes_cnn(self) -> bool:
        return bool(self.manifest.get("frame_programs"))

    @property
    def frame_shape(self) -> List[int]:
        if not self.includes_cnn:
            raise ValueError(f"{self.path} has no CNN-inclusive programs (re-export with "
                             "include_cnn=True / --include-cnn)")
        return list(self.manifest["cnn"]["frame_shape"])

    def predict_from_frames(self, frames, **options) -> List[Dict[str, object]]:
        """uint8 RGB frames (B, T, H, W, 3), or a list of (T, H, W, 3)
        clips, through the frames -> CNN -> decode program."""
        if options:
            self.validate_options(options)
        T, H, W, C = self.frame_shape
        if isinstance(frames, (list, tuple)):
            for i, clip in enumerate(frames):
                if list(np.shape(clip)) != [T, H, W, C]:
                    raise ValueError(f"clip {i}: expected ({T}, {H}, {W}, {C}) frames, got "
                                     f"{np.shape(clip)} (resample/resize on the host first)")
            frames = (np.stack([np.asarray(c) for c in frames]) if frames
                      else np.zeros((0, T, H, W, C), np.uint8))
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            raise ValueError(f"frames must be uint8 RGB (normalization is baked into the "
                             f"program), got {frames.dtype}")
        if frames.ndim != 5 or list(frames.shape[1:]) != [T, H, W, C]:
            raise ValueError(f"expected (B, {T}, {H}, {W}, {C}) frames, got {frames.shape}")
        return self._run("frame_programs", sorted(self.manifest["cnn"]["frame_batch_sizes"]),
                         frames)

    def _records(self, out, real: int) -> List[Dict[str, object]]:
        tokens = out["generated_tokens"][:real].cpu().numpy()
        scores = out["all_scores"][:real].cpu().numpy() if "all_scores" in out else None
        records = []
        for i in range(real):
            rec: Dict[str, object] = {"caption": self.decode_caption(tokens[i].tolist()),
                                      "tokens": tokens[i].tolist(), "method": self.method}
            if scores is not None:
                rec["score"] = float(scores[i][0])
            records.append(rec)
        return records
