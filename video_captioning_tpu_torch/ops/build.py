"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``_build/`` beside the package, named by a hash of its
source and the compiler flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Builds happen at first use, never at
import; where ``nvcc`` is missing the build raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available to
# later versions of the kernels; -Xptxas -v reports registers and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_CUDA_ROOTS = ("/usr/local/cuda",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME``/``$CUDA_PATH``, then ``PATH``, then
    the toolkit's usual install root. Raises when there is none."""
    roots = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    for root in [r for r in roots if r] + list(_CUDA_ROOTS):
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of video_captioning_tpu_torch cannot be built"
    )


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``. Thread-safe; the
    library is cached for the life of the process."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _library_path(name)
        if not so.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
            build_logs[name] = (
                f"built {so.name} in {time.perf_counter() - t0:.1f}s\n"
                f"{proc.stdout}{proc.stderr}"
            )
        lib = ctypes.CDLL(str(so))
        lib.vct_error_string.argtypes = [ctypes.c_int]
        lib.vct_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib.vct_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
