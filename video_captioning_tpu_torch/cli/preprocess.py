"""Preprocess CLI: offline feature extraction + dataset CSV.

The port's copy of video_captioning_tpu/cli/preprocess.py, with the same
flags and artifacts: per-video ``{stem}.npy`` features (uniform sampling
of ``--frames-per-video`` frames, padded with the last frame) and an
optional ``video_id,video_path,feature_path,caption`` dataset CSV, written
with the ``csv`` module to the bytes pandas' ``to_csv(index=False)`` writes.
Existing ``.npy`` files are skipped unless ``--overwrite``. Videos decode on
host threads while the CNN runs on ``--device`` (the card by default);
frames go there as uint8 (models.backbones.FeatureExtractor).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


class VideoFeatureExtractor:
    """Directory-level feature extraction driver."""

    def __init__(
        self,
        model_type: str = "vgg16",
        batch_size: int = 32,
        frames_per_video: int = 80,
        img_size: tuple = (224, 224),
        weights_path: Optional[Path] = None,
        allow_random_init: bool = False,
        num_workers: int = 8,
        variant: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        device: str = "cuda",
        config=None,
    ):
        from ..models.backbones import FeatureExtractor

        self.frames_per_video = frames_per_video
        self.img_size = img_size
        self.num_workers = num_workers
        self.backbone = FeatureExtractor(
            model_type, config, weights_path=weights_path, batch_size=batch_size,
            allow_random_init=allow_random_init,
            variant=variant, compute_dtype=compute_dtype, device=device,
        )
        logger.info(f"Initialized {model_type} feature extractor")

    def extract_video_features(self, video_path: Path) -> np.ndarray:
        from ..data.video import extract_frames

        frames = extract_frames(
            video_path, self.frames_per_video,
            resize=self.img_size, pad_mode="last",
        )
        return self.backbone.extract(frames)

    def process_video_directory(
        self,
        video_dir: Path,
        output_dir: Path,
        video_extensions: Optional[List[str]] = None,
        overwrite: bool = False,
    ) -> List[Path]:
        if video_extensions is None:
            video_extensions = [".mp4", ".avi", ".mov", ".mkv", ".wmv"]

        video_files: List[Path] = []
        for ext in video_extensions:
            video_files.extend(video_dir.glob(f"*{ext}"))
            video_files.extend(video_dir.glob(f"*{ext.upper()}"))
        logger.info(f"Found {len(video_files)} video files")

        output_dir.mkdir(parents=True, exist_ok=True)
        processed, failed = [], []
        pending: List[Path] = []
        for video_path in video_files:
            out_path = output_dir / f"{video_path.stem}.npy"
            if out_path.exists() and not overwrite:
                logger.info(f"Skipping existing features: {out_path}")
                processed.append(out_path)
            else:
                pending.append(video_path)

        # Worker-pool decode overlapped with on-device extraction: videos
        # decode concurrently (threads; cv2 drops the GIL) and the CNN
        # consumes each clip as its decode finishes, in submission order.
        # The reference decodes and extracts strictly serially
        # (preprocess.py:177-226).
        from concurrent.futures import ThreadPoolExecutor

        from ..data.video import extract_frames

        def decode(path):
            return extract_frames(
                path, self.frames_per_video,
                resize=self.img_size, pad_mode="last",
            )

        from collections import deque

        window = 2 * max(1, self.num_workers)  # bounds decoded-frame RAM
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as ex:
            queue: deque = deque()
            it = iter(pending)

            def drain_one():
                video_path, fut = queue.popleft()
                out_path = output_dir / f"{video_path.stem}.npy"
                try:
                    features = self.backbone.extract(fut.result())
                    np.save(out_path, features)
                    processed.append(out_path)
                except Exception as e:
                    logger.error(f"Failed to process {video_path}: {e}")
                    failed.append(video_path)

            for p in it:
                queue.append((p, ex.submit(decode, p)))
                if len(queue) >= window:
                    drain_one()
            while queue:
                drain_one()

        logger.info(f"Successfully processed {len(processed)} videos")
        if failed:
            logger.warning(f"Failed to process {len(failed)} videos")
        return processed


def create_dataset_csv(
    video_dir: Path,
    features_dir: Path,
    captions_file: Optional[Path],
    output_file: Path,
) -> None:
    """Match feature stems to videos and join captions: a CSV caption file
    by exact ``video_id`` then by substring, a TXT file by line order."""
    import csv

    feature_files = list(features_dir.glob("*.npy"))
    logger.info(f"Found {len(feature_files)} feature files")

    entries = []
    for feature_path in feature_files:
        video_id = feature_path.stem
        video_path = None
        for ext in [".mp4", ".avi", ".mov", ".mkv", ".wmv"]:
            candidate = video_dir / f"{video_id}{ext}"
            if candidate.exists():
                video_path = candidate
                break
        if video_path is None:
            logger.warning(f"No video file found for feature file: {feature_path}")
            continue
        entries.append(
            {
                "video_id": video_id,
                "video_path": str(video_path),
                "feature_path": str(feature_path),
                "caption": "",
            }
        )

    if captions_file and captions_file.exists():
        logger.info(f"Loading captions from {captions_file}")
        if captions_file.suffix == ".csv":
            with open(captions_file, newline="", encoding="utf-8") as f:
                rows = [(r.get("video_id") or "", r.get("caption") or "")
                        for r in csv.DictReader(f)]
            for entry in entries:
                vid = entry["video_id"]
                match = next((c for v, c in rows if v == vid), None)
                if match is None:
                    # Literal substring match: stems like "clip(1)" are not patterns.
                    match = next((c for v, c in rows if vid in v), None)
                if match is not None:
                    entry["caption"] = match
        elif captions_file.suffix == ".txt":
            with open(captions_file) as f:
                lines = [line.strip() for line in f]
            for i, entry in enumerate(entries):
                if i < len(lines):
                    entry["caption"] = lines[i]

    columns = ["video_id", "video_path", "feature_path", "caption"]
    with open(output_file, "w", newline="", encoding="utf-8") as f:
        if entries:
            writer = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
            writer.writeheader()
            writer.writerows(entries)
        else:
            f.write("\n")  # what pandas writes for a frame with no columns
    logger.info(f"Created dataset CSV with {len(entries)} entries: {output_file}")
    with_captions = sum(1 for e in entries if e["caption"] != "")
    logger.info(f"Entries with captions: {with_captions}/{len(entries)}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Extract features from videos")
    parser.add_argument("--video-dir", type=str, required=True, help="Directory containing videos")
    parser.add_argument("--output-dir", type=str, required=True, help="Directory to save features")
    parser.add_argument("--model-type", type=str, default="vgg16",
                        choices=["vgg16", "resnet50"], help="CNN model type")
    parser.add_argument("--weights", type=str,
                        help="Path to pretrained CNN weights (native .npz from "
                             "convert_weights, raw .npz, or pickled state dict)")
    parser.add_argument("--allow-random-init", action="store_true",
                        help="Proceed without pretrained weights (random CNN; "
                             "features are meaningless for caption quality)")
    parser.add_argument("--batch-size", type=int, default=32, help="Batch size for processing")
    parser.add_argument("--backbone-variant", type=str, default=None,
                        choices=["xla", "folded", "fused", "fused_s2d",
                                 "int8"],
                        help="CNN forward variant (BN-folded / fused Pallas "
                             "bottleneck / space-to-depth stem / W8A8 int8 "
                             "PTQ — int8 works for both backbones and is "
                             "approximate); default: config (ResNet50: folded)")
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="CNN compute dtype (default float32)")
    parser.add_argument("--num-workers", type=int, default=8,
                        help="Concurrent video-decode threads (host side)")
    parser.add_argument("--frames-per-video", type=int, default=80, help="Number of frames per video")
    parser.add_argument("--img-size", type=int, nargs=2, default=[224, 224], help="Image size for CNN")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device the CNN runs on (cuda or cpu)")
    parser.add_argument("--log-level", type=str, default="INFO", help="Logging level")

    parser.add_argument("--create-dataset", action="store_true", help="Create dataset CSV file")
    parser.add_argument("--captions-file", type=str, help="File containing captions")
    parser.add_argument("--dataset-output", type=str, default="dataset.csv", help="Output dataset CSV file")

    parser.add_argument("--video-extensions", type=str, nargs="+",
                        default=[".mp4", ".avi", ".mov", ".mkv", ".wmv"],
                        help="Video file extensions to process")
    parser.add_argument("--overwrite", action="store_true", help="Overwrite existing feature files")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)

    video_dir = Path(args.video_dir)
    output_dir = Path(args.output_dir)
    if not video_dir.exists():
        raise ValueError(f"Video directory does not exist: {video_dir}")

    extractor = VideoFeatureExtractor(
        model_type=args.model_type,
        batch_size=args.batch_size,
        frames_per_video=args.frames_per_video,
        img_size=tuple(args.img_size),
        weights_path=Path(args.weights) if args.weights else None,
        allow_random_init=args.allow_random_init,
        num_workers=args.num_workers,
        variant=args.backbone_variant,
        compute_dtype=args.compute_dtype,
        device=args.device,
    )

    logger.info("Starting feature extraction...")
    processed = extractor.process_video_directory(
        video_dir=video_dir, output_dir=output_dir,
        video_extensions=args.video_extensions, overwrite=args.overwrite,
    )
    logger.info(f"Feature extraction completed. Processed {len(processed)} videos.")

    if args.create_dataset:
        logger.info("Creating dataset CSV...")
        create_dataset_csv(
            video_dir=video_dir, features_dir=output_dir,
            captions_file=Path(args.captions_file) if args.captions_file else None,
            output_file=Path(args.dataset_output),
        )
    logger.info("Preprocessing completed successfully!")


if __name__ == "__main__":
    main()
