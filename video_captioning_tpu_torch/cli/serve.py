"""Serve CLI: HTTP captioning daemon with dynamic batching, on PyTorch.

    python -m video_captioning_tpu_torch.cli.serve \\
        --model-path checkpoints/model_for_inference.pth \\
        --device cuda --port 8080 --max-batch 64 --max-wait-ms 5

Counterpart of video_captioning_tpu/cli/serve.py. It takes the same
inference packages; ``--compute-dtype bfloat16`` serves bfloat16
parameters, ``--decode-int8 vocab|full`` W8A8 decode matrices
(``models/quantize.py``) and ``--data-parallel`` one replica on each
device that ``--device`` names (an ``(n_devices, 1)`` mesh,
``inference/predictor.py``: every visible card for ``cuda``, one for
``cuda:i``, the CPU for ``cpu``).
``--model-path`` also takes a ``.vcx`` artifact (``cli/export.py``),
served by ``ExportedPredictor`` with no model code; the flags such an
artifact cannot honour (``--data-parallel``, ``--decode-int8``, a
``--compute-dtype`` other than the baked one) exit with the JAX CLI's
errors. ``--compilation-cache-dir`` is accepted and logged.
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
                        help="Inference package (.pth) or serving artifact (.vcx, from "
                             "the export CLI)")
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
                        help="bfloat16 casts the parameters once at load")
    parser.add_argument("--decode-int8", type=str, default="off",
                        choices=["off", "vocab", "full"],
                        help="Opt-in W8A8 decode quantization (models/quantize.py): "
                             "approximate tokens")
    parser.add_argument("--data-parallel", action="store_true",
                        help="One replica on each device --device names (cuda: every visible "
                             "card), device batches split over them")
    parser.add_argument("--compilation-cache-dir", type=str, default=None,
                        help="Accepted for the JAX CLI's flags; PyTorch has no such cache")
    parser.add_argument("--log-level", type=str, default="INFO")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    model_path = Path(args.model_path)
    if model_path.suffix == ".vcx":
        # The artifact's programs carry their options, dtype and device:
        # the flags they cannot honour are errors, not silent ignores.
        if args.data_parallel:
            raise SystemExit(
                "--data-parallel is not supported with .vcx artifacts (exported programs "
                "are single-device; run one server per card behind a load balancer)")
        if args.decode_int8 != "off":
            raise SystemExit(
                "--decode-int8 applies at model-load time; .vcx programs "
                "are already compiled (serve the .pth package with "
                "--decode-int8 instead)"
            )
    setup_logging(args.log_level)

    if model_path.suffix == ".vcx":
        from ..inference.export import ExportedPredictor

        predictor = ExportedPredictor(model_path, device=args.device)
        baked = predictor.manifest.get("compute_dtype", "float32")
        if args.compute_dtype and args.compute_dtype != baked:
            raise SystemExit(
                f"--compute-dtype {args.compute_dtype} conflicts with this artifact's baked "
                f"compute_dtype={baked} (re-export with --compute-dtype to change it)")
        logger.info("serving artifact %s (method=%s, buckets=%s)", model_path,
                    predictor.method, predictor.batch_sizes)
        _serve(predictor, args)
        return

    from ..inference.predictor import VideoCaptionPredictor

    kwargs = {}
    if args.data_parallel:
        from ..config import Config
        from ..parallel import make_mesh

        kwargs["mesh"] = make_mesh(Config(), data_parallel_devices(args.device))
        logger.info(f"data-parallel serving over {kwargs['mesh'].shape['data']} devices")
    if args.compilation_cache_dir:
        kwargs["compilation_cache_dir"] = args.compilation_cache_dir
    predictor = VideoCaptionPredictor(model_path, device=args.device,
                                      compute_dtype=args.compute_dtype,
                                      decode_int8=args.decode_int8, **kwargs)
    _serve(predictor, args)


def data_parallel_devices(device: str) -> list:
    """The devices ``--data-parallel`` serves on, one replica each, from
    ``--device``: ``cuda`` every visible card, ``cuda:i`` that card, ``cpu``
    the CPU. A card that is not there raises, naming it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev]
    if dev.type != "cuda":
        raise ValueError(f"--device {device!r}: --data-parallel serves on cuda or cpu")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.index is None:
        if count == 0:
            raise RuntimeError(f"--device {device!r}: no CUDA device is visible here; pass "
                               "--device cpu to serve on the CPU")
        return [torch.device("cuda", i) for i in range(count)]
    if dev.index >= count:
        raise RuntimeError(f"--device {device!r}: CUDA device {dev.index} is not visible "
                           f"({count} visible)")
    return [dev]


def _serve(predictor, args) -> None:
    from ..inference.server import CaptionServer

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
