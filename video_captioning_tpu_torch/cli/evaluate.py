"""Evaluation CLI on PyTorch, in two modes.

Counterpart of video_captioning_tpu/cli/evaluate.py, printing the same
JSON:

* file mode: a predictions text file scored against a references text
  file, one caption a line (``utils.metrics.evaluate_model_outputs``);

      python -m video_captioning_tpu_torch.cli.evaluate \\
          --predictions preds.txt --references refs.txt

* dataset mode: the model over a split of a dataset CSV (read without
  pandas by ``data.pipeline``; ``--split all`` takes every row whose
  feature file exists), one prediction a ``video_id`` (first-seen order)
  in device batches of ``--batch-size``, scored against the clip's first
  reference and against all of them, with the diversity metrics.

      python -m video_captioning_tpu_torch.cli.evaluate \\
          --model-path checkpoints/model_for_inference.pth --data-file captions.csv

``--device`` names the torch device and defaults to ``cuda``; on a host
without one the predictor raises. ``--method sample`` draws from a generator
seeded at 0, as the JAX CLI's key is.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


def evaluate_files(args) -> dict:
    from ..utils.metrics import evaluate_model_outputs

    return evaluate_model_outputs(args.predictions, args.references)


def evaluate_dataset(args) -> dict:
    import numpy as np

    from ..data.pipeline import prepare_data, read_captions_csv
    from ..inference.predictor import VideoCaptionPredictor
    from ..utils.metrics import CaptionMetrics, compute_metrics_multi_reference

    predictor = VideoCaptionPredictor(Path(args.model_path), device=args.device)
    config = predictor.config
    if args.split == "all":
        rows = [r for r in read_captions_csv(args.data_file) if os.path.exists(r["feature_path"])]
    else:
        config.data.captions_file = Path(args.data_file)
        train, val, test = prepare_data(config)
        rows = {"train": train, "val": val, "test": test}[args.split]
    logger.info(f"Evaluating {len(rows)} rows from split '{args.split}'")

    # One prediction per video, its references grouped in first-seen order.
    groups: dict = {}
    for r in rows:
        groups.setdefault(r["video_id"], []).append(r)
    video_ids = list(groups)
    feature_paths = [g[0]["feature_path"] for g in groups.values()]
    reference_groups = [[str(r["caption"]) for r in g] for g in groups.values()]

    predictions = []
    for start in range(0, len(feature_paths), args.batch_size):
        feats = [np.load(p) for p in feature_paths[start:start + args.batch_size]]
        results = predictor.predict_batch(feats, method=args.method, max_length=args.max_length,
                                          beam_size=args.beam_size,
                                          length_penalty=args.length_penalty)
        predictions.extend(r["caption"] for r in results)

    scorer = CaptionMetrics(predictor.vocabulary)
    single_ref = scorer.compute_metrics(predictions, [refs[0] for refs in reference_groups])
    single_ref.update(scorer.compute_diversity_metrics(predictions))
    return {
        "num_videos": len(video_ids),
        "method": args.method,
        "single_reference": single_ref,
        "multi_reference": compute_metrics_multi_reference(predictions, reference_groups),
        "samples": [{"video_id": v, "prediction": p, "references": r[:3]}
                    for v, p, r in list(zip(video_ids, predictions, reference_groups))[:5]],
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate generated captions (PyTorch)")
    parser.add_argument("--predictions", type=str,
                        help="Text file: one predicted caption per line")
    parser.add_argument("--references", type=str,
                        help="Text file: one reference caption per line")
    parser.add_argument("--model-path", type=str, help="Inference package path")
    parser.add_argument("--data-file", type=str, help="Dataset CSV")
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "val", "test", "all"])
    parser.add_argument("--method", type=str, default="beam",
                        choices=["greedy", "beam", "sample"])
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--max-length", type=int, default=20)
    parser.add_argument("--length-penalty", type=float, default=1.0)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on, e.g. cuda, cuda:1, cpu")
    parser.add_argument("--output", type=str, help="Output JSON file")
    parser.add_argument("--log-level", type=str, default="INFO")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    if args.predictions and args.references:
        results = evaluate_files(args)
    elif args.model_path and args.data_file:
        results = evaluate_dataset(args)
    else:
        raise SystemExit("Provide either --predictions + --references (file mode) or "
                         "--model-path + --data-file (dataset mode)")
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
