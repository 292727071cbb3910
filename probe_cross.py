"""beam_cross_attention's kept design on one card, at the fused beam
step's shape (B = 128, K = 5, S = 80, D = 512, 8 heads), against the two
designs it replaced, and its host time a call by part:

    python3 probe_cross.py designs
    python3 probe_cross.py host --other DIR

``designs`` (float32 and bfloat16 keys and values): the variants are built from this tree's ``csrc/transformer_attn.cu`` with
a mode added to its cross kernel (the source is patched as text, written
to the gitignored ``_build/`` and compiled there by ``nvcc`` with the
package's flags):

* mode 0, the kept design: scores and weights in this beam and head's row
  of the L2-resident scratch, the head mean in a second launch;
* mode 1, the weights in shared memory (K x S floats a CTA), copied to the
  scratch at the end for the second launch;
* mode 2, the weights in shared memory and the head mean in the same
  launch, over a cluster of the clip's 8 head CTAs reading each other's
  weights in head order through distributed shared memory.

Every mode must give the library kernel's bits on two seeded input sets.
Then each mode and the library's own launch are timed by CUDA-graph
replay (``compare_attention._graph_ms``), warm (one input set) and cold
(two in turn), in turns (library, 0, 1, 2, 2, 1, 0, library, three
times).

``host`` (float32): the host's own time a call (perf_counter over 200
calls without a sync, median of 7, the parts in turns) of the wrapper
``beam_cross_attention``, of its C entry called directly with the same
arguments, of its plan (``cross_vec`` + ``cross_plan``), of its three
allocations and of its device context, and of the C entry of another
checkout ``DIR`` (built from its ``csrc/transformer_attn.cu`` into this
tree's ``_build/``), which must take the arguments the entry took
before ``vec`` and frames a chunk were added.

Each prints its medians beside the card's name and power limit and a JSON
line last. Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from compare_attention import _graph_ms, _in_turn, _same_bits
from video_captioning_tpu_torch.ops import build
from video_captioning_tpu_torch.ops import transformer_attn as ta

B, K, S, D, H = 128, 5, 80, 512, 8
LABELS = {"lib": "library kernel (kept design)",
          0: "mode 0, kept design (probe build)",
          1: "mode 1, weights in shared memory, head mean in a second launch",
          2: "mode 2, weights in shared memory, head mean over a cluster of 8"}

# (old, new) text edits of csrc/transformer_attn.cu; each must match once.
PATCHES = (
    ("#include <algorithm>\n", "#include <cooperative_groups.h>\n#include <algorithm>\n"),
    ("  float* wh;  // (B*K, H, S) per-head scores, then weights\n",
     "  float* wh;  // (B*K, H, S) per-head scores, then weights\n"
     "  float* wout;  // (B*K, S) head mean (mode 2)\n  int off_w;\n"),
    ("template <typename T, typename TQ, int kEpl, bool kVec>\n"
     "__global__ void beam_cross_attn_kernel(",
     "template <typename T, typename TQ, int kEpl, bool kVec, int kMode>\n"
     "__global__ void beam_cross_attn_kernel("),
    ("  float* prow = a.wh + (n * H + head) * S;\n",
     "  float* ws = reinterpret_cast<float*>(smem + a.off_w);  // [K][S] (modes 1, 2)\n"
     "  float* prow = kMode ? ws + k * S : a.wh + (n * H + head) * S;\n"),
    ("    if (d < dh) store_out(static_cast<TQ*>(a.ctx) + n * D + col0 + d, acc[i]);\n  }\n}",
     """    if (d < dh) store_out(static_cast<TQ*>(a.ctx) + n * D + col0 + d, acc[i]);
  }
  if (kMode == 1) {
    float* g = a.wh + (n * H + head) * S;
    for (int s = lane; s < S; s += 32) g[s] = prow[s];
  }
  if (kMode == 2) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const int KS = K * S;
    for (int e = head * nthr + tid; e < KS; e += H * nthr) {
      float acc = 0.0f;
      for (int h = 0; h < H; ++h) acc += cl.map_shared_rank(ws, h)[e];
      a.wout[static_cast<size_t>(b) * KS + e] = acc / static_cast<float>(H);
    }
    cl.sync();
  }
}"""),
    ("  auto kernel = beam_cross_attn_kernel<T, TQ, kEpl, kVec>;",
     "  auto kernel = beam_cross_attn_kernel<T, TQ, kEpl, kVec, 0>;"),
)

ENTRY = r'''
namespace {
template <typename T, int kMode>
cudaError_t probe_launch(const CrossArgs& a, int B, int H, cudaStream_t st) {
  auto kernel = beam_cross_attn_kernel<T, float, 2, true, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, H);
  cfg.blockDim = dim3(32 * a.K);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = H;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMode == 2 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}
}  // namespace

// Vector copies and 32 < dh <= 64 only (the main shape).
extern "C" int vct_probe_cross(const float* q, const void* ck, const void* cv, const float* mask,
                               float* ctx, float* wh, float* w, int kv_bf16, int B, int K, int H,
                               int D, int S, int FC, int mode, void* stream) {
  const int esz = kv_bf16 ? 2 : 4;
  CrossArgs a = {};
  a.q = q; a.ck = ck; a.cv = cv; a.mask = mask; a.ctx = ctx; a.wh = wh; a.wout = w;
  a.K = K; a.D = D; a.dh = D / H; a.S = S;
  a.scale = 1.0f / sqrtf(static_cast<float>(a.dh));
  a.FC = FC;
  a.nch = (S + FC - 1) / FC;
  if (a.dh <= 32 || a.dh > 64 || !cross_layout(a, true, esz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.off_w = a.smem;
  if (mode > 0) a.smem += round16(4L * K * S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode * 2 + kv_bf16) {
    case 0: err = probe_launch<float, 0>(a, B, H, st); break;
    case 1: err = probe_launch<__nv_bfloat16, 0>(a, B, H, st); break;
    case 2: err = probe_launch<float, 1>(a, B, H, st); break;
    case 3: err = probe_launch<__nv_bfloat16, 1>(a, B, H, st); break;
    case 4: err = probe_launch<float, 2>(a, B, H, st); break;
    default: err = probe_launch<__nv_bfloat16, 2>(a, B, H, st); break;
  }
  if (err != cudaSuccess || mode == 2) return static_cast<int>(err);
  const int NS = B * K * S;
  head_mean_kernel<<<(NS + kMeanThreads - 1) / kMeanThreads, kMeanThreads, 0, st>>>(wh, w, NS,
                                                                                    H, S);
  return static_cast<int>(cudaGetLastError());
}
'''


def build_source(stem: str, src: str) -> ctypes.CDLL:
    """``src`` built once into ``_build/`` by its hash, and loaded."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{stem}_{hashlib.sha256(src.encode()).hexdigest()[:16]}"
    cu, so = build.BUILD_DIR / f"{stem}.cu", build.BUILD_DIR / f"{stem}.so"
    if not so.exists():
        cu.write_text(src)
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def probe_library() -> ctypes.CDLL:
    """This tree's cross kernel with the mode added."""
    src = (build.CSRC_DIR / "transformer_attn.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/transformer_attn.cu no longer matches the probe's edit "
                               f"of {old[:60]!r}")
        src = src.replace(old, new)
    lib = build_source("probe_cross", src + ENTRY)
    lib.vct_probe_cross.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.vct_probe_cross.restype = ctypes.c_int
    return lib


def cross_inputs(seed: int, dtype: torch.dtype) -> tuple:
    """compare_attention.py's timing inputs: q, keys, values, a ragged mask
    with row 1 fully masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B * K, D), generator=g)
    ck = torch.randn((B, S, D), generator=g).to(dtype)
    cv = torch.randn((B, S, D), generator=g).to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=g)
    mask = (torch.arange(S)[None, :] < lengths[:, None]).float()
    mask[1] = 0.0
    return tuple(t.cuda() for t in (q, ck, cv, mask))


def probe(lib: ctypes.CDLL, dtype: torch.dtype) -> dict:
    sets = [cross_inputs(30 + i, dtype) for i in range(2)]
    plan = ta.cross_plan(K, H, D, S, sets[0][1].element_size(), True)
    outs = [(torch.empty((B * K, D), device="cuda"), torch.empty((B * K, H, S), device="cuda"),
             torch.empty((B * K, S), device="cuda")) for _ in sets]

    def call(mode: int, i: int) -> None:
        (q, ck, cv, mask), (ctx, wh, w) = sets[i], outs[i]
        rc = lib.vct_probe_cross(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), mask.data_ptr(),
                                 ctx.data_ptr(), wh.data_ptr(), w.data_ptr(),
                                 int(dtype == torch.bfloat16), B, K, H, D, S, plan["FC"], mode,
                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"vct_probe_cross mode {mode}: CUDA error {rc}")

    for mode in (0, 1, 2):
        for i in range(len(sets)):
            want = [t.cpu() for t in ta.beam_cross_attention(*sets[i], H, K)]
            call(mode, i)
            got = [outs[i][0].cpu(), outs[i][2].cpu()]
            if not _same_bits({"x": got}, {"x": want})["x"]:
                raise AssertionError(f"{dtype} mode {mode}: not the library kernel's bits")
    times = {m: {"warm": [], "cold": []} for m in LABELS}
    for m in ["lib", 0, 1, 2, 2, 1, 0, "lib"] * 3:
        if m == "lib":
            warm = lambda: ta.beam_cross_attention(*sets[0], H, K)  # noqa: E731
            cold = _in_turn([lambda s=s: ta.beam_cross_attention(*s, H, K) for s in sets])
        else:
            warm = lambda m=m: call(m, 0)  # noqa: E731
            cold = _in_turn([lambda m=m, i=i: call(m, i) for i in range(len(sets))])
        times[m]["warm"].append(_graph_ms(torch, warm))
        times[m]["cold"].append(_graph_ms(torch, cold))
    return {LABELS[m]: {k: statistics.median(v) for k, v in t.items()} for m, t in times.items()}


def designs() -> dict:
    lib = probe_library()
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, t in probe(lib, dtype).items():
            name = f"{str(dtype)[6:]} {label}"
            result[name] = t
            print(f"{name}: graph replay {t['warm']:.4f} ms warm, {t['cold']:.4f} ms cold "
                  f"(every mode the library kernel's bits)", flush=True)
    return result


def _host_ms(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def host(other: Path) -> dict:
    olib = build_source("other_transformer_attn",
                        (other / "video_captioning_tpu_torch/csrc/transformer_attn.cu").read_text())
    olib.vct_beam_cross_attention.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                              + [ctypes.c_void_p])
    lib = ta._kernel_lib()
    q, ck, cv, mask = cross_inputs(30, torch.float32)
    ctx, w = torch.empty_like(q), torch.empty((B * K, S), device="cuda")
    wh = torch.empty((B * K, H, S), device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    FC = ta.cross_plan(K, H, D, S, 4, True)["FC"]
    ptrs = [t.data_ptr() for t in (q, ck, cv, mask, ctx, wh, w)]

    def device_context():
        with torch.cuda.device(q.device):
            return torch.cuda.current_stream(q.device).cuda_stream

    parts = {
        "wrapper": lambda: ta.beam_cross_attention(q, ck, cv, mask, H, K),
        "C entry": lambda: lib.vct_beam_cross_attention(*ptrs, 0, 0, B, K, H, D, S, 1, FC,
                                                        ta.heads_per_block(D, H), st),
        "other tree's C entry": lambda: olib.vct_beam_cross_attention(*ptrs, 0, B, K, H, D, S,
                                                                      st),
        "plan (cross_vec + cross_plan)": lambda: ta.cross_plan(K, H, D, S, ck.element_size(),
                                                               ta.cross_vec(ck, cv, H)),
        "three allocations": lambda: (torch.empty_like(q), torch.empty_like(w),
                                      torch.empty_like(wh)),
        "device context and stream": device_context,
    }
    times = {k: [] for k in parts}
    for r in range(7):
        for k in (list(parts) if r % 2 == 0 else list(reversed(parts))):
            times[k].append(_host_ms(parts[k]))
    result = {k: statistics.median(v) for k, v in times.items()}
    for k, v in result.items():
        print(f"host {k}: {v * 1e3:.2f} us a call (runs {[round(x * 1e3, 1) for x in times[k]]})",
              flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("designs", help="the kept design against the two it replaced")
    hp = sub.add_parser("host", help="the host's time a call, by part")
    hp.add_argument("--other", type=Path, required=True, help="the other tree's root")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_cross: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    result = designs() if args.what == "designs" else host(args.other.resolve())
    print(card)
    print(json.dumps({"card": card, "what": args.what, "median_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
