"""Serve CLI: HTTP captioning daemon with dynamic batching, on PyTorch.

    python -m video_captioning_tpu_torch.cli.serve \\
        --model-path checkpoints/model_for_inference.pth \\
        --device cuda --port 8080 --max-batch 64 --max-wait-ms 5

Counterpart of video_captioning_tpu/cli/serve.py. It takes the same
inference packages. Flags of that CLI that are not ported yet
(``--compute-dtype bfloat16``, ``--decode-int8``, ``--data-parallel``,
``.vcx`` artifacts) exit with an error instead of being ignored.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="HTTP captioning server with dynamic batching (PyTorch)")
    parser.add_argument("--model-path", type=str, required=True,
                        help="Inference package (.pth)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on, e.g. cuda, cuda:1, cpu")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-batch", type=int, default=64,
                        help="Max clips per device batch")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="Max time a lone request waits for batchmates")
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=[None, "float32", "bfloat16"],
                        help="only float32 is ported")
    parser.add_argument("--decode-int8", type=str, default="off",
                        choices=["off", "vocab", "full"], help="not ported")
    parser.add_argument("--data-parallel", action="store_true", help="not ported")
    parser.add_argument("--log-level", type=str, default="INFO")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    not_ported = [
        (args.compute_dtype == "bfloat16", "--compute-dtype bfloat16"),
        (args.decode_int8 != "off", "--decode-int8"),
        (args.data_parallel, "--data-parallel"),
        (Path(args.model_path).suffix == ".vcx", ".vcx artifacts"),
    ]
    for bad, name in not_ported:
        if bad:
            raise SystemExit(f"{name} is not ported to video_captioning_tpu_torch yet")
    setup_logging(args.log_level)

    from ..inference.predictor import VideoCaptionPredictor
    from ..inference.server import CaptionServer

    predictor = VideoCaptionPredictor(args.model_path, device=args.device)
    server = CaptionServer(predictor, host=args.host, port=args.port,
                           max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    print(f"caption server listening on {args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
        server.close()


if __name__ == "__main__":
    main()
