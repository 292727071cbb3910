"""Prediction CLI on PyTorch: ``single``, ``batch`` and ``multiple``.

Counterpart of video_captioning_tpu/cli/predict.py with the same flags and
outputs (printed captions, the ``--output`` JSON, ``--captions-file``):

    python -m video_captioning_tpu_torch.cli.predict \\
        --model-path checkpoints/model_for_inference.pth --method beam \\
        single --video-path clip.mp4 [--features-path clip.npy]
    ... batch --video-list videos.txt | --features-dir features/ [--batch-size 8]
    ... multiple --video-path clip.mp4 --num-captions 5

``--device`` names the torch device and defaults to ``cuda``; on a host
without one the predictor raises (``--device cpu`` runs on the CPU).
``--feature-mode`` picks how a video becomes features: ``pixel_stub`` (the
upstream predictor's flattened pixels, the default) or ``cnn`` (VGG16 or
ResNet50 on the device; ``--cnn-weights`` or ``--allow-random-cnn-init``).
``--method sample`` draws from a generator seeded at 0, as the JAX CLI's
key is (``--temperature`` scales the logits).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from ..utils.logging import setup_logging


def _predictor(args):
    from ..inference.predictor import VideoCaptionPredictor

    return VideoCaptionPredictor(
        Path(args.model_path), device=args.device, feature_mode=args.feature_mode,
        cnn_weights_path=Path(args.cnn_weights) if args.cnn_weights else None,
        allow_random_cnn_init=args.allow_random_cnn_init)


def _write_json(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    logging.getLogger(__name__).info(f"Results saved to: {path}")


def predict_single_video(args) -> None:
    predictor = _predictor(args)
    logging.getLogger(__name__).info(f"Generating caption for: {args.video_path}")
    gen = dict(method=args.method, max_length=args.max_length, beam_size=args.beam_size,
               length_penalty=args.length_penalty, temperature=args.temperature)
    if args.features_path:
        result = predictor.predict_from_features(np.load(args.features_path), **gen)
    else:
        result = predictor.predict_from_video(Path(args.video_path), **gen)

    print(f"\nGenerated Caption: {result['caption']}")
    print(f"Method: {result['method']}")
    print(f"Tokens: {result['tokens']}")
    if args.output:
        _write_json(args.output, {
            "video_path": args.video_path,
            "caption": result["caption"],
            "method": args.method,
            "tokens": result["tokens"],
            "parameters": {"max_length": args.max_length, "beam_size": args.beam_size,
                           "length_penalty": args.length_penalty,
                           "temperature": args.temperature},
        })


def predict_batch_videos(args) -> None:
    from ..inference.predictor import BatchPredictor

    logger = logging.getLogger(__name__)
    if not args.video_list and not args.features_dir:
        raise SystemExit("batch requires --video-list or --features-dir")
    predictor = _predictor(args)
    gen = dict(method=args.method, max_length=args.max_length, beam_size=args.beam_size,
               length_penalty=args.length_penalty, temperature=args.temperature)

    if args.features_dir:
        # Pre-extracted .npy features, one device batch a chunk.
        feature_paths = sorted(Path(args.features_dir).glob("*.npy"))
        logger.info(f"Found {len(feature_paths)} feature files")
        results = []
        for start in range(0, len(feature_paths), args.batch_size):
            chunk = feature_paths[start:start + args.batch_size]
            chunk_results = predictor.predict_batch([np.load(p) for p in chunk], **gen)
            for p, r in zip(chunk, chunk_results):
                r["video_path"] = str(p)
            results.extend(chunk_results)
    else:
        if args.video_list.endswith(".txt"):
            with open(args.video_list, "r") as f:
                video_paths = [Path(line.strip()) for line in f if line.strip()]
        else:
            video_dir = Path(args.video_list)
            video_paths = []
            for ext in [".mp4", ".avi", ".mov", ".mkv", ".wmv"]:
                video_paths.extend(video_dir.glob(f"*{ext}"))
        logger.info(f"Found {len(video_paths)} videos to process")
        results = BatchPredictor(predictor, batch_size=args.batch_size).predict_videos(
            video_paths=video_paths, **gen)

    for result in results:
        print(f"\nVideo: {result.get('video_path', 'Unknown')}")
        if "error" in result:
            print(f"Error: {result['error']}")
        else:
            print(f"Caption: {result['caption']}")
    if args.output:
        _write_json(args.output, {
            "parameters": {"method": args.method, "max_length": args.max_length,
                           "beam_size": args.beam_size, "length_penalty": args.length_penalty,
                           "temperature": args.temperature},
            "results": [{k: v for k, v in r.items() if k != "attention_weights"}
                        for r in results],
        })
    if args.captions_file:
        with open(args.captions_file, "w") as f:
            for result in results:
                f.write(("" if "error" in result else result["caption"]) + "\n")
        logger.info(f"Captions saved to: {args.captions_file}")


def predict_multiple_captions(args) -> None:
    predictor = _predictor(args)
    if args.features_path:
        features = np.load(args.features_path)
    else:
        features = predictor._extract_video_features(Path(args.video_path))
    logging.getLogger(__name__).info(
        f"Generating {args.num_captions} captions for: {args.video_path}")
    captions = predictor.generate_multiple_captions(
        video_features=features, num_captions=args.num_captions, method=args.method,
        max_length=args.max_length, beam_size=max(args.beam_size, args.num_captions),
        temperature=args.temperature)

    print(f"\nGenerated {len(captions)} captions:")
    for i, item in enumerate(captions, 1):
        print(f"{i}. {item['caption']} (score: {item['score']:.3f})")
    if args.output:
        _write_json(args.output, {
            "video_path": args.video_path,
            "captions": captions,
            "parameters": {"num_captions": args.num_captions, "method": args.method,
                           "max_length": args.max_length, "beam_size": args.beam_size,
                           "temperature": args.temperature},
        })


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate video captions (PyTorch)")
    parser.add_argument("--model-path", type=str, required=True, help="Path to trained model")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on, e.g. cuda, cuda:1, cpu")
    parser.add_argument("--log-level", type=str, default="INFO", help="Logging level")
    parser.add_argument("--feature-mode", type=str, default="pixel_stub",
                        choices=["pixel_stub", "cnn"], help="On-the-fly feature extraction mode")
    parser.add_argument("--cnn-weights", type=str,
                        help="Pretrained CNN weights for --feature-mode cnn (native .npz from "
                             "convert_weights, or a torchvision state file)")
    parser.add_argument("--allow-random-cnn-init", action="store_true",
                        help="Run --feature-mode cnn without pretrained weights (random CNN; "
                             "captions meaningless)")
    parser.add_argument("--method", type=str, default="greedy",
                        choices=["greedy", "beam", "sample"], help="Generation method")
    parser.add_argument("--max-length", type=int, default=20, help="Maximum caption length")
    parser.add_argument("--beam-size", type=int, default=5, help="Beam size for beam search")
    parser.add_argument("--length-penalty", type=float, default=1.0,
                        help="Length penalty for beam search")
    parser.add_argument("--temperature", type=float, default=1.0, help="Temperature for sampling")

    subparsers = parser.add_subparsers(dest="command", help="Available commands")
    single = subparsers.add_parser("single", help="Predict caption for single video")
    single.add_argument("--video-path", type=str, required=True, help="Path to video file")
    single.add_argument("--features-path", type=str, help="Path to pre-extracted features")
    single.add_argument("--output", type=str, help="Output JSON file")

    batch = subparsers.add_parser("batch", help="Predict captions for multiple videos")
    batch.add_argument("--video-list", type=str,
                       help="Text file with video paths or directory with videos")
    batch.add_argument("--features-dir", type=str,
                       help="Directory of pre-extracted .npy features (device-batched)")
    batch.add_argument("--batch-size", type=int, default=8, help="Batch size for processing")
    batch.add_argument("--output", type=str, help="Output JSON file")
    batch.add_argument("--captions-file", type=str, help="Output text file with captions only")

    multiple = subparsers.add_parser("multiple",
                                     help="Generate multiple captions for single video")
    multiple.add_argument("--video-path", type=str, required=True, help="Path to video file")
    multiple.add_argument("--features-path", type=str, help="Path to pre-extracted features")
    multiple.add_argument("--num-captions", type=int, default=5,
                          help="Number of captions to generate")
    multiple.add_argument("--output", type=str, help="Output JSON file")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return
    setup_logging(args.log_level)
    {"single": predict_single_video, "batch": predict_batch_videos,
     "multiple": predict_multiple_captions}[args.command](args)


if __name__ == "__main__":
    main()
