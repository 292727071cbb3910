"""Where the cycles of the fused bottleneck kernel go, on the card.

Builds a copy of ``video_captioning_tpu_torch/csrc/fused_bottleneck.cu``
with clock64() readings added around the parts of its block product (the
consumers' wait for a full ring slot, their products, the epilogue; the
producers' wait for a free slot and their copies' issue), runs one launch
at each ResNet50 stage's identity-block shape (B = 32) and prints cycles a
k-tile, per phase, averaged over the warps. The readings slow the kernel a
little; they say where the time goes, not how long a launch takes (that is
chip_smoke.py's). The source is left as it is.

    python3 chip_profile.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from chip_smoke import RESNET_STAGES, bottleneck_inputs, card_line
from video_captioning_tpu_torch.ops import bottleneck as bmod
from video_captioning_tpu_torch.ops import build

# (text in the source, its replacement): the readings.
EDITS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_prof[32];\n"),
    ("__device__ void block_gemm(int M,", "__device__ void block_gemm(int ph, int M,"),
    ("block_gemm<T, kVec, MT1, true>(M1", "block_gemm<T, kVec, MT1, true>(0, M1"),
    ("block_gemm<T, kVec, MT2, false>(M2, sw", "block_gemm<T, kVec, MT2, false>(1, M2, sw"),
    ("block_gemm<T, kVec, MT2, false>(M2, nco", "block_gemm<T, kVec, MT2, false>(2, M2, nco"),
    ("""    for (int i = 0; i < total; ++i) {
      const int slot = (seq0 + i) % kStages, use = (seq0 + i) / kStages;
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);""",
     """    unsigned long long pw = 0, pi = 0;
    for (int i = 0; i < total; ++i) {
      const int slot = (seq0 + i) % kStages, use = (seq0 + i) / kStages;
      const unsigned long long t0 = clock64();
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
      const unsigned long long t1 = clock64();
      pw += t1 - t0;"""),
    ("""        mbar_arrive_cp_async(&full[slot]);
      } else {""", """        mbar_arrive_cp_async(&full[slot]);
        pi += clock64() - t1;
      } else {"""),
    ("""    __syncthreads();  // the ring is refilled by the next phase
    return;
  }""", """    if (threadIdx.x % 32 == 0) {
      atomicAdd(&g_prof[ph * 8 + 4], pw);
      atomicAdd(&g_prof[ph * 8 + 5], pi);
      atomicAdd(&g_prof[ph * 8 + 7], 1ull);
    }
    __syncthreads();  // the ring is refilled by the next phase
    return;
  }"""),
    ("""  for (int i = 0; i < total; ++i) {
    const int s = (seq0 + i) % kStages, kt = i % nk, mn = i / nk;
    mbar_wait(&full[s], ((seq0 + i) / kStages) & 1);""",
     """  unsigned long long cw = 0, cm = 0, ce = 0, tl = clock64();
  for (int i = 0; i < total; ++i) {
    const int s = (seq0 + i) % kStages, kt = i % nk, mn = i / nk;
    const unsigned long long t0 = clock64();
    ce += t0 - tl;
    mbar_wait(&full[s], ((seq0 + i) / kStages) & 1);
    const unsigned long long t1 = clock64();
    cw += t1 - t0;"""),
    ("""    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with slot s""",
     """    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with slot s
    tl = clock64();
    cm += tl - t1;"""),
    ("""  __syncthreads();  // the ring is refilled by the next phase
}""", """  if (lane == 0) {
    atomicAdd(&g_prof[ph * 8 + 0], cw);
    atomicAdd(&g_prof[ph * 8 + 1], cm);
    atomicAdd(&g_prof[ph * 8 + 2], ce);
    atomicAdd(&g_prof[ph * 8 + 3], static_cast<unsigned long long>(total));
    atomicAdd(&g_prof[ph * 8 + 6], 1ull);
  }
  __syncthreads();  // the ring is refilled by the next phase
}"""),
    ('extern "C" const char* vct_error_string(int code) {',
     """extern "C" int vct_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[32] = {};
    err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  }
  return static_cast<int>(err == cudaSuccess ? cudaDeviceSynchronize() : err);
}

extern "C" const char* vct_error_string(int code) {"""),
)


def build_profiled(directory: Path) -> ctypes.CDLL:
    """The kernel's source with the readings, built into ``directory``."""
    src = directory / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    path = src / "fused_bottleneck.cu"
    text = path.read_text()
    for old, new in EDITS:
        if old not in text:
            raise RuntimeError(f"chip_profile: the source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    so = directory / "fused_bottleneck_profiled.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.vct_error_string.argtypes = [ctypes.c_int]
    lib.vct_error_string.restype = ctypes.c_char_p
    for dt in ("f32", "bf16"):
        getattr(lib, f"vct_fused_bottleneck_{dt}").argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        getattr(lib, f"vct_fused_bottleneck_plan_{dt}").argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.vct_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_profiled(Path(tmp))
        bmod._kernel_lib = lambda: lib
        buf = (ctypes.c_ulonglong * 32)()
        for stage, (H, C, Cm) in enumerate(RESNET_STAGES, start=1):
            for dtype in (torch.float32, torch.bfloat16):
                x, ws = bottleneck_inputs("cuda", 32, H, H, C, Cm, dtype, seed=41 + stage)
                bmod.fused_bottleneck(x, *ws)  # warm-up
                torch.cuda.synchronize()
                lib.vct_profile(buf, 1)
                bmod.fused_bottleneck(x, *ws)
                torch.cuda.synchronize()
                rc = lib.vct_profile(buf, 0)
                if rc != 0:
                    raise RuntimeError(f"chip_profile: CUDA error {rc}")
                plan = bmod.kernel_plan(x, Cm)
                print(f"[profile] stage {stage} (B=32, {H}x{H}, C={C}, Cm={Cm}) {dtype}, work "
                      f"item {plan} ({card}): cycles a k-tile, averaged over the warps")
                for ph in range(3):
                    v = buf[ph * 8: ph * 8 + 8]
                    consumers, producers, tiles = v[6], v[7], v[3]
                    if consumers == 0 or tiles == 0:
                        continue
                    per_producer_tile = tiles / consumers * producers
                    print(f"[profile]   phase {ph + 1}: {tiles / consumers:.0f} k-tiles a warp; "
                          f"consumers: wait {v[0] / tiles:.0f}, products {v[1] / tiles:.0f}, "
                          f"epilogue and loop {v[2] / tiles:.0f}; producers: wait for a slot "
                          f"{v[4] / per_producer_tile:.0f}, copies' issue "
                          f"{v[5] / per_producer_tile:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
