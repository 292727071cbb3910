"""beam_self_attention's kept design on one card, at the fused beam step's
shape (B = 128, K = 5, D = 512, 8 heads, T = 21, t = 19), against variants
of it and another checkout's kernel:

    python3 probe_self.py --other DIR [--rounds 2]

Each variant is this tree's ``csrc/transformer_attn.cu`` edited as text
(``VARIANTS``: other stage sizes and ring depths, and, for timing only,
the copies alone, the arithmetic alone and a build that records lane 0's
clock at each step of a stage), with an entry appended that reports the
kernel's registers, local memory and CTAs an SM at the main shape, and
built into the gitignored ``_build/`` by ``probe_cross.build_source``;
"kept design (probe build)" is the source unedited. ``DIR`` holds another
checkout (for example the parent commit unpacked with ``git archive`` into
the gitignored ``_scratch/``), whose ``csrc/transformer_attn.cu`` is built
the same way and called through the same C entry. Every variant but the
timing-only ones must give the other checkout's bits in each of the three
forms (float32 query and caches, bfloat16 caches, bfloat16 query and
caches) on two seeded input sets (``chip_smoke.beam_self_inputs``, seeds
20 and 21). Then each, and the package's own build, is timed by
CUDA-graph replay (``compare_attention._graph_ms``), warm (one input set)
and cold (the two in turn), in turns (other, library, the variants, then
back, ``--rounds`` times); the other tree's and the library build at
other batch sizes and steps (``SCALING``) beside a one-element add (a
graph node's floor); and the stage clocks of beam 0 alone and in the
full grid. Prints each variant's registers, CTAs an SM, plan and medians
beside the card's name and power limit, and a JSON line last. Needs a
CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import SELF_MAIN, beam_self_inputs
from compare_attention import SELF_FORMS, _graph_ms, _in_turn, _same_bits
from probe_cross import build_source
from video_captioning_tpu_torch.ops import build
from video_captioning_tpu_torch.ops import transformer_attn as ta

_COPY = """          const T* vr = kr + R;
          float part[4];
"""
_STAMPS = 24  # clock stamps a lane keeps (the first 1 + 3 stages' worth)
# name: (old, new) text edits of csrc/transformer_attn.cu; each must match once.
VARIANTS = {
    "kept design (probe build)": (),
    "stages of 2 positions, 8 at most": (
        ("kSelfStage = 4;", "kSelfStage = 2;"), ("kSelfMaxStages = 3;", "kSelfMaxStages = 8;")),
    "stages of 1 position, 16 at most": (
        ("kSelfStage = 4;", "kSelfStage = 1;"), ("kSelfMaxStages = 3;", "kSelfMaxStages = 16;")),
    "two stages at most": (("kSelfMaxStages = 3;", "kSelfMaxStages = 2;"),),
    "four stages at most": (("kSelfMaxStages = 3;", "kSelfMaxStages = 4;"),),
    "the copies alone (timing only)": (
        (_COPY, _COPY.replace("          float part[4];\n",
                              "          acc[0][0] += to_f32(kr[g]) + to_f32(vr[g]);\n"
                              "          l = 1.0f;\n          continue;\n"
                              "          float part[4];\n")),),
    "the arithmetic alone (timing only)": (
        ("        if (live && kVec) {", "        if (false && kVec) {"),
        ("        } else if (live) {\n          for (int d = g; d < dh; d += 8) {",
         "        } else if (false) {\n          for (int d = g; d < dh; d += 8) {")),
    "stage clocks (timing only)": (
        ("  int read = 0;  // the slot of the next stage to read\n",
         "  int read = 0;  // the slot of the next stage to read\n"
         f"  long long stamp[{_STAMPS}];\n  const long long t0 = clock64();\n"
         f"#define STAMP(i) if ((i) < {_STAMPS}) stamp[(i)] = clock64() - t0\n"),
        ("      __syncwarp();          // and the other lanes'\n",
         "      __syncwarp();          // and the other lanes'\n      STAMP(1 + 3 * s);\n"),
        ("      __syncwarp();  // every lane is done with the slot\n",
         "      __syncwarp();  // every lane is done with the slot\n      STAMP(2 + 3 * s);\n"),
        ("    cp_async_commit();\n  }\n  if (!live) return;\n",
         "    cp_async_commit();\n    STAMP(s < 0 ? 0 : 3 + 3 * s);\n  }\n  if (!live) return;\n"
         f"  if (lane == 0) {{\n    for (int i = 0; i < {_STAMPS} && i < 1 + 3 * nst && i < D; ++i) {{\n"
         "      store_out(static_cast<TQ*>(a.ctx) + n * D + i, static_cast<float>(stamp[i]));\n"
         "    }\n  }\n  return;\n")),
}
# Appended to every variant: the main shape's instantiation (dh = 64: two
# columns a lane, 16-byte copies, every column in range) with the launch's
# shared-memory attributes; out: CTAs an SM, registers, local bytes.
ENTRY = """
template <typename T, typename TQ>
int probe_self_kernel(int smem, int* out) {
  auto kernel = beam_self_attn_kernel<T, TQ, 2, true, true>;
  static std::atomic<int> allowed[kMaxDevices];
  static std::mutex setting;
  cudaError_t err = allow_smem(kernel, smem, allowed, setting);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, 32, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

extern "C" int vct_probe_self_kernel(int cache_bf16, int q_bf16, int smem, int* out) {
  using bf16 = __nv_bfloat16;
  if (cache_bf16) return q_bf16 ? probe_self_kernel<bf16, bf16>(smem, out)
                                : probe_self_kernel<bf16, float>(smem, out);
  return q_bf16 ? probe_self_kernel<float, bf16>(smem, out)
                : probe_self_kernel<float, float>(smem, out);
}
"""
# The library build and the other tree's at other batch sizes and steps:
# (B, t), float32 and bfloat16 caches.
SCALING = ((1, 0), (1, 19), (16, 19), (64, 19), (128, 19), (256, 19), (128, 0), (128, 9))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vct_beam_self_attention.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.vct_beam_self_attention.restype = i32
    if hasattr(lib, "vct_probe_self_kernel"):
        lib.vct_probe_self_kernel.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
        lib.vct_probe_self_kernel.restype = i32
        lib.vct_beam_self_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
        lib.vct_beam_self_plan.restype = i32
    return lib


def variant_source(edits: tuple) -> str:
    """This tree's csrc/transformer_attn.cu with ``edits`` and ENTRY."""
    src = (build.CSRC_DIR / "transformer_attn.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/transformer_attn.cu no longer matches the probe's edit "
                               f"of {old[:60]!r}")
        src = src.replace(old, new)
    return src + ENTRY


def kernel_facts(lib: ctypes.CDLL, q_bf16: bool, cache_bf16: bool) -> dict:
    """A variant's plan at the main shape (its own launcher's), and CTAs an
    SM, registers and local bytes of its kernel there; {} for a build
    without the probe entry (the other tree's, the library's)."""
    if not hasattr(lib, "vct_probe_self_kernel"):
        return {}
    B, K, D, H, T, t = SELF_MAIN
    plan = (ctypes.c_int * 2)()
    out = (ctypes.c_int * 3)()
    rc = lib.vct_beam_self_plan(K, D // H, t, int(cache_bf16), plan)
    rc = rc or lib.vct_probe_self_kernel(int(cache_bf16), int(q_bf16), plan[1], out)
    if rc != 0:
        raise RuntimeError(f"vct_probe_self_kernel failed ({rc})")
    return dict(stages=plan[0], smem=plan[1], ctas_an_sm=out[0], registers=out[1],
                local_bytes=out[2])


def scaling(libs: dict, H: int, K: int, D: int, T: int, rounds: int) -> dict:
    """The other tree's and the library build's warm graph-replay times at
    SCALING's (B, t), float32 and bfloat16 caches, in turns."""
    one = torch.zeros(1, device="cuda")
    floor = statistics.median(_graph_ms(torch, lambda: one.add_(1.0)) for _ in range(3))
    result = {"a one-element add (a graph node's floor)": floor}
    print(f"a one-element add: graph replay {floor:.4f} ms", flush=True)
    for cdt in (torch.float32, torch.bfloat16):
        for B, t in SCALING:
            q, kc, vc, anc = beam_self_inputs("cuda", B, K, D, T, t, torch.float32, 20)
            args = (q, kc.to(cdt), vc.to(cdt), anc)
            times = {"other": [], "library (kept design)": []}
            for _ in range(rounds):
                for name in list(times) + list(times)[::-1]:
                    ta._kernel_lib = lambda lib=libs[name]: lib
                    times[name].append(_graph_ms(
                        torch, lambda: ta.beam_self_attention(*args, t, H, K)))
            for name, v in times.items():
                key = f"caches {str(cdt)[6:]}, B {B}, t {t}: {name}"
                result[key] = statistics.median(v)
                print(f"{key}: graph replay {result[key]:.4f} ms warm", flush=True)
    return result


def libraries(other: Path) -> dict:
    """The other checkout's build, the library build and every variant,
    built in parallel."""
    jobs = {"other": lambda: build_source("other_transformer_attn", (
                other / "video_captioning_tpu_torch/csrc/transformer_attn.cu").read_text()),
            "library (kept design)": lambda: build.load_library("transformer_attn")}
    jobs.update({name: (lambda e=e: build_source("probe_self", variant_source(e)))
                 for name, e in VARIANTS.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in jobs.items()}
        return {name: typed(f.result()) for name, f in futures.items()}


def stage_clocks(lib: ctypes.CDLL, H: int, K: int, D: int, T: int, t: int) -> dict:
    """Lane 0's clock (cycles from its start) after its first issues, then
    after each stage's wait, arithmetic and next issue, in the build that
    records them, float32: for beam 0 alone (B = 1) and for beams 0 and
    N / 2 of the full grid (B = 128)."""
    kernel_lib = ta._kernel_lib
    ta._kernel_lib = lambda: lib
    result = {}
    try:
        for B in (1, 128):
            q, kc, vc, anc = beam_self_inputs("cuda", B, K, D, T, t, torch.float32, 20)
            for _ in range(3):  # warm, as the graph replays run
                out = ta.beam_self_attention(q, kc, vc, anc, t, H, K)
            torch.cuda.synchronize()
            nst = t // ta.SELF_STAGE + 1
            for n in sorted({0, (B * K) // 2}):
                key = f"B {B}, beam {n}"
                result[key] = [int(x) for x in out[n, :1 + 3 * nst].tolist()]
                print(f"stage clocks, {key} (issued; then wait, arithmetic, issue a stage): "
                      f"{result[key]}", flush=True)
    finally:
        ta._kernel_lib = kernel_lib
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2, help="passes there and back")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_self: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = libraries(args.other.resolve())
    B, K, D, H, T, t = SELF_MAIN
    kernel_lib = ta._kernel_lib
    result = {}
    try:
        for tag, qdt, cdt in SELF_FORMS:
            form = f"q {str(qdt)[6:]}, caches {str(cdt)[6:]}"
            sets = []
            for seed in (20, 21):
                q, kc, vc, anc = beam_self_inputs("cuda", B, K, D, T, t, torch.float32, seed)
                sets.append((q.to(qdt), kc.to(cdt), vc.to(cdt), anc))
            want = []
            for name, lib in libs.items():
                ta._kernel_lib = lambda lib=lib: lib
                got = [ta.beam_self_attention(*s, t, H, K).cpu() for s in sets]
                if not want:
                    want = got
                elif "timing only" not in name and not _same_bits({"x": got}, {"x": want})["x"]:
                    raise AssertionError(f"{form}: {name} does not give the other tree's bits")
            times = {name: {"warm": [], "cold": []} for name in libs}
            order = list(libs)
            for _ in range(args.rounds):
                for name in order + order[::-1]:
                    ta._kernel_lib = lambda lib=libs[name]: lib
                    times[name]["warm"].append(_graph_ms(
                        torch, lambda: ta.beam_self_attention(*sets[0], t, H, K)))
                    times[name]["cold"].append(_graph_ms(torch, _in_turn(
                        [lambda s=s: ta.beam_self_attention(*s, t, H, K) for s in sets])))
            for name, tm in times.items():
                med = {k: statistics.median(v) for k, v in tm.items()}
                result[f"{form}: {name}"] = med
                facts = kernel_facts(libs[name], qdt == torch.bfloat16, cdt == torch.bfloat16)
                print(f"{form}: {name}: graph replay {med['warm']:.4f} ms warm, "
                      f"{med['cold']:.4f} ms cold {facts}", flush=True)
        result.update(scaling(libs, H, K, D, T, args.rounds))
        result["stage clocks"] = stage_clocks(libs["stage clocks (timing only)"], H, K, D, T, t)
    finally:
        ta._kernel_lib = kernel_lib
    print(card)
    print(json.dumps({"card": card, "median_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
