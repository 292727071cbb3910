"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``_build/`` beside the package, named by a hash of its
source and the compiler flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is; nvcc's output (ptxas's registers and
spills a kernel) is kept beside it as ``.log`` and read into
``build_logs`` either way. Builds happen at first use, never at import;
where ``nvcc`` is missing the build raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from typing import Dict, Sequence

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
_name_locks: Dict[str, threading.Lock] = {}
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


def _library_path(name: str, flags: Sequence[str]) -> Path:
    # The shared headers are part of every source's hash.
    parts = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts) + " ".join(flags).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def load_library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with ``-D`` for each of
    ``defines`` (a variant built to time against the plain build).
    Thread-safe, with one lock per build, so different sources build in
    parallel; the library is cached for the life of the process."""
    key = " ".join([name, *defines])
    with _lock:
        name_lock = _name_locks.setdefault(key, threading.Lock())
    with name_lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
        so = _library_path(name, flags)
        log = so.with_suffix(".log")
        if not so.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            tmp_log = so.with_suffix(f".{os.getpid()}.logtmp")
            tmp_log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp_log, log)  # before the library, so a loader of it finds its log
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
            build_logs[key] = (
                f"built {so.name} in {time.perf_counter() - t0:.1f}s\n"
                f"{proc.stdout}{proc.stderr}"
            )
        elif key not in build_logs and log.exists():
            build_logs[key] = f"loaded {so.name}, built earlier\n{log.read_text()}"
        lib = ctypes.CDLL(str(so))
        lib.vct_error_string.argtypes = [ctypes.c_int]
        lib.vct_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
        return lib


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Build and load several sources at once, one ``nvcc`` each, all
    started together. Returns the seconds each took to be ready."""
    def one(name: str) -> float:
        t0 = time.perf_counter()
        load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(one, names)))


def tracing() -> bool:
    """Whether the caller runs under ``torch.export`` (or ``torch.compile``)
    tracing: the wrappers then call their ``vct::`` custom op
    (``ops/library.py``), which the traced program keeps."""
    return torch.compiler.is_compiling()


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib.vct_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
