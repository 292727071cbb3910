"""Logging setup (parity: reference src/utils/logging.py:7-26); the port's
copy of video_captioning_tpu/utils/logging.py."""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional, Union


def setup_logging(
    level: Union[int, str] = "INFO", log_file: Optional[Union[str, Path]] = None
) -> logging.Logger:
    """Configure root logging with console and optional file handlers."""
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)

    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(level)
    console.setFormatter(fmt)
    root.addHandler(console)

    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(level)
        fh.setFormatter(fmt)
        root.addHandler(fh)

    return root
