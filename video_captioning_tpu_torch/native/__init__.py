"""Native (C++) host components, bound with ctypes.

The port's copy of video_captioning_tpu/native: ``load_features_batch``
loads a batch of ``.npy`` feature files into one (B, T, F) float32 array
in C++ (``vcload.cc``: parallel reads without the GIL, the uniform resample
or zero pad of ``data.pipeline.resample_features``). ``g++`` builds the
library at first use into ``video_captioning_tpu_torch/_build/`` (named by
a hash of the source and flags), never beside the source. A failed build
is logged once as a warning and the callers take the Python path; so does
a file layout the loader does not take (anything but a C-order float32
(T, F) array).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "vcload.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"vcload_{digest[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        return True
    except Exception as e:
        logger.warning(f"native loader build failed ({e}); using Python path")
        return False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib_handle, _build_failed
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        if _build_failed:
            return None
        so = library_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning(f"native loader unavailable ({e}); using Python path")
            _build_failed = True
            return None
        lib.vc_load_features_batch.restype = ctypes.c_int
        lib.vc_load_features_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long,
        ]
        _lib_handle = lib
        return lib


def native_available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _get_lib() is not None


def load_features_batch(paths: Sequence[str], target_len: int,
                        feat_dim: int) -> Optional[np.ndarray]:
    """float32 (T, F) ``.npy`` files -> (B, target_len, feat_dim), each
    resampled or zero-padded as ``resample_features`` does; None where the
    native path cannot serve the request (no library, or any file it does
    not take), and the caller then loads in Python."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, target_len, feat_dim), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.vc_load_features_batch(c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    target_len, feat_dim)
    if rc != 0:
        logger.debug(f"native loader failed on item {rc - 1}; Python path")
        return None
    return out

