"""Export CLI: trained inference package -> serving artifact (.vcx).

Counterpart of video_captioning_tpu/cli/export.py with its flags: the
predictor's generation program is traced once per batch bucket with
``torch.export``, the weights inside it, and served by
``inference.export.ExportedPredictor`` with no model code or weight file.

    python -m video_captioning_tpu_torch.cli.export \\
        --model-path checkpoints/model_for_inference.pth \\
        --output model.vcx --batch-sizes 1,8,64 \\
        --method beam --beam-size 5 [--compute-dtype bfloat16] \\
        [--platforms cuda,cpu]

``--platforms`` names the devices the programs are exported for (a
program holds its device: ``cuda``, the default, or ``cpu``); ``--device``
is the same for one device, as the JAX CLI's platform override.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Export a serving artifact of torch.export programs")
    parser.add_argument("--model-path", type=str, required=True,
                        help="Trained inference package (.pth)")
    parser.add_argument("--output", type=str, required=True, help="Output artifact path (.vcx)")
    parser.add_argument("--batch-sizes", type=str, default="1,8,64",
                        help="Comma-separated batch buckets to export")
    parser.add_argument("--method", type=str, default="beam", choices=["beam", "greedy"])
    parser.add_argument("--max-length", type=int, default=20)
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--length-penalty", type=float, default=1.0)
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=[None, "float32", "bfloat16"])
    parser.add_argument("--platforms", type=str, default=None,
                        help="Comma-separated devices to export for (cuda,cpu); default: "
                             "--device, else cuda")
    parser.add_argument("--device", type=str, default=None,
                        help="One device to export for (cuda or cpu)")
    parser.add_argument("--include-cnn", action="store_true",
                        help="Also export full-pipeline programs (uint8 frames -> CNN -> "
                             "beam/greedy) beside the features-only buckets")
    parser.add_argument("--cnn-weights", type=str, default=None,
                        help="Backbone weights for --include-cnn: native .vcw.npz, quantized "
                             "vcw-int8-v1 (implies the int8 variant), or a torchvision state file")
    parser.add_argument("--cnn-model-type", type=str, default=None,
                        choices=[None, "vgg16", "resnet50"],
                        help="Backbone for --include-cnn; default from cnn_feature_dim")
    parser.add_argument("--cnn-variant", type=str, default=None,
                        choices=[None, "xla", "folded", "fused", "fused_s2d", "int8"],
                        help="Backbone forward variant for --include-cnn")
    parser.add_argument("--allow-random-cnn-init", action="store_true",
                        help="Export with a random-init backbone (pipeline testing only)")
    parser.add_argument("--frame-batch-sizes", type=str, default=None,
                        help="Comma-separated frame-program buckets (default: --batch-sizes)")
    parser.add_argument("--cnn-chunk", type=int, default=320,
                        help="Frames per in-program CNN chunk (bounds activation memory)")
    parser.add_argument("--log-level", type=str, default="INFO")
    return parser


def _ints(text):
    return [int(b) for b in text.split(",") if b.strip()]


def main(argv=None) -> Path:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)

    from ..inference.export import export_serving_artifact

    batch_sizes = _ints(args.batch_sizes)
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()] if args.platforms
                 else [args.device or "cuda"])
    out = export_serving_artifact(
        Path(args.model_path), Path(args.output), batch_sizes=batch_sizes,
        method=args.method, max_length=args.max_length, beam_size=args.beam_size,
        length_penalty=args.length_penalty, compute_dtype=args.compute_dtype,
        platforms=platforms, include_cnn=args.include_cnn,
        cnn_weights_path=Path(args.cnn_weights) if args.cnn_weights else None,
        cnn_model_type=args.cnn_model_type, cnn_variant=args.cnn_variant,
        allow_random_cnn_init=args.allow_random_cnn_init,
        frame_batch_sizes=_ints(args.frame_batch_sizes) if args.frame_batch_sizes else None,
        cnn_chunk=args.cnn_chunk)
    size_mb = out.stat().st_size / 2**20
    print(f"wrote {out} ({size_mb:.1f} MiB, buckets {batch_sizes}, method={args.method}"
          + (", +cnn" if args.include_cnn else "") + ")")
    return out


if __name__ == "__main__":
    main()
