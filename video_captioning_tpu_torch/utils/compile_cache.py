"""``experiment.compilation_cache_dir``: accepted, and nothing to enable.

Counterpart of video_captioning_tpu/utils/compile_cache.py, which points
JAX's persistent XLA compilation cache at the directory. The port compiles
no program ahead of time (its kernels are built once per checkout into
``_build/``, ``ops/build.py``), so the value is kept for config
compatibility and one log line says it has no effect.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

logger = logging.getLogger(__name__)


def enable_compilation_cache(cache_dir: Optional[Union[str, Path]]) -> None:
    if cache_dir:
        logger.info(f"compilation_cache_dir={cache_dir}: PyTorch has no XLA compilation "
                    "cache; the kernels are built once into the package's _build/ directory")


def maybe_enable_from_config(config) -> None:
    enable_compilation_cache(config.experiment.compilation_cache_dir)
