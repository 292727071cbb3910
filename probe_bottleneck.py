"""Where the time of another checkout's fused_bottleneck goes, on one card:
its plan, the clusters the card co-schedules, its cost model's estimate
and the times of variants with parts removed.

    python3 probe_bottleneck.py --other DIR

``DIR`` holds another checkout (for example the parent commit unpacked
with ``git archive`` into the gitignored ``_scratch/``). Each variant is
that checkout's ``csrc/fused_bottleneck.cu`` edited as text (``VARIANTS``;
an edit that no longer matches fails by name), with an entry appended that
reports the launcher's plan, its CTAs and clusters, the clusters of that
plan the card runs at once (``cudaOccupancyMaxActiveClusters``, asked for
the kernel the launcher picks at the plan's shared memory), the waves of
clusters that follow, the launcher's own ``plan_cost`` estimate (clocks a
launch, and ms at the card's clock) and the kernel's registers. Each is
built into the gitignored ``_build/`` (one ``nvcc`` each, all started
together) and called through its C entry at the four ResNet50 stages'
identity blocks (B = 32) in float32 and bfloat16, on
``chip_smoke.bottleneck_inputs``, timed by CUDA-graph replay
(``compare_attention._graph_ms``: ten launches a graph, median of 5):

* the checkout's design as it is;
* (a) no products (the tensor-core instructions removed; timing only);
* (b) no gathers and no ``cluster.sync()`` (timing only);
* (c) phase 1's x not staged: the producers copy only the weights
  (timing only);
* (d) only the clusters of the first wave launched (the grid cut to the
  active-cluster count; timing only).

With ``--plans N``, this tree's kernel runs each stage under the N work
items ``ops/bottleneck.py:plan_candidates`` ranks first, beside each
one's ``plan_cost`` estimate.

With ``--this``, the same stages run through this tree's wrapper on
variants of this tree's ``csrc/fused_bottleneck.cu`` (``THIS_VARIANTS``,
each timing only but the first: (e) no products, (f) no output tile
epilogue, (h) no residual loads, (i) no y1 / y2 stores into Y, (g) no
copies; and (j), clock64() readings at the phase boundaries, CTA means of
the parts' clocks), beside its plan, error and registers.

Prints each variant's times beside the plan and the estimate, the card's
name and power limit, and a JSON line last. Needs a CUDA card and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import RESNET_STAGES, bottleneck_inputs, card_line
from compare_attention import _graph_ms
from probe_lstm import build_variant, ptxas

VARIANTS = {
    "the checkout's design": (),
    "(a) no products (timing only)": (
        ("      vct_tc::warp_mma_rows<T, MT, 4>(acc, rows, ring_b + (s * kBN + wn * 32) * kStride);\n",
         "      acc[0][0][0] += __uint_as_float(rows[0][lane % 4]);\n"),),
    "(b) no gathers, no cluster.sync() (timing only)": (
        ("  cluster.sync();  // every slice of y1 written\n  gather_slices<T>(Y, S, NPOS, cs);\n"
         "  cluster.sync();  // every CTA holds y1; S may be overwritten\n",
         "  __syncthreads();\n"),
        ("  cluster.sync();  // every slice of y2 written; no CTA still reads its Y\n"
         "  gather_slices<T>(Y, S, M2, cs);\n  __syncthreads();\n", "  __syncthreads();\n"),
        ("  cluster.sync();  // peers may still read this CTA's S\n}", "}")),
    "(c) phase 1's x not staged (timing only)": (
        ("        for (int r = threadIdx.x - kThreads; r < ROWS; r += kProducers) {\n"
         "          int count;\n          uint32_t* dst;\n          const T* src = row(r, count, dst);\n"
         "#pragma unroll",
         "        for (int r = threadIdx.x - kThreads; r < kBN; r += kProducers) {\n"
         "          int count;\n          uint32_t* dst;\n          const T* src = row(r, count, dst);\n"
         "#pragma unroll"),),
    "(d) the first wave of clusters alone (timing only)": (
        ("  const int items = ceil_div(B, p.ni) * args.tiles;\n",
         "  const int items = std::min(ceil_div(B, p.ni) * args.tiles, g_probe_cap);\n"),
        ("namespace {\n\nusing vct_tc::kStride;", "namespace {\n\nint g_probe_cap = 1 << 30;\n\n"
                                                  "using vct_tc::kStride;")),
}

_NO_TMA = tuple((f"          {c}(", f"          if (false) {c}(") for c in ("tma_3d", "tma_2d"))
# name: (old, new) text edits of this tree's csrc/fused_bottleneck.cu.
THIS_VARIANTS = {
    "this tree's design (probe build)": (),
    "(e) no products (timing only)": (
        ("  constexpr bool kF32 = sizeof(T) == 4;\n  if constexpr (N == 32) {",
         "  return;\n  constexpr bool kF32 = sizeof(T) == 4;\n  if constexpr (N == 32) {"),
        ("__device__ __forceinline__ void wgmma_step_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {\n",
         "__device__ __forceinline__ void wgmma_step_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {\n"
         "  return;\n")),
    "(f) no output tile epilogue (timing only)": (
        ("              store_out<T>(ring", "              if (false) store_out<T>(ring"),
        ("              tma_store_4d(&maps.out,", "              if (false) tma_store_4d(&maps.out,")),
    "(h) no residual loads (timing only)": (
        ("  mbar_expect_tx(bar, round * box_bytes);", "  mbar_expect_tx(bar, 0);"),
        ("    tma_4d(rg.base + b * rg.slot, map,", "    if (false) tma_4d(rg.base + b * rg.slot, map,")),
    "(i) no y1 / y2 stores into Y (timing only)": (
        ("                                             const uint32_t (&row_at)[MB][2], int cs) {\n",
         "                                             const uint32_t (&row_at)[MB][2], int cs) {\n"
         "  if (cs > 0) return;\n"),),
    "(j) clock64 at the phase boundaries": (
        ("namespace {\n\nusing vct_tc::smem_addr;",
         "namespace {\n\n__device__ unsigned long long g_clk[16][4096];\n"
         "#define VCT_CLK(k) if (threadIdx.x == 0) g_clk[k][blockIdx.x] = clock64()\n\n"
         "using vct_tc::smem_addr;"),
        ("  if (threadIdx.x >= kConsumers) {\n", "  VCT_CLK(0);\n  if (threadIdx.x >= kConsumers) {\n"),
        ("  int seq = 0;\n", "  int seq = 0;\n  unsigned long long ew = 0, es = 0, et = 0;\n"),
        ("                               a.yrow);\n", "                               a.yrow);\n    VCT_CLK(1);\n"),
        ("  consumers_sync(cbar, cs, &syncs);  // every CTA holds y1\n",
         "  VCT_CLK(2);\n  consumers_sync(cbar, cs, &syncs);  // every CTA holds y1\n  VCT_CLK(3);\n"),
        ("pos_addr, nkc, a.HX, a.yrow);\n", "pos_addr, nkc, a.HX, a.yrow);\n    VCT_CLK(4);\n"),
        ("    consumers_sync(cbar, cs, &syncs);  // no CTA still reads y1\n",
         "    consumers_sync(cbar, cs, &syncs);  // no CTA still reads y1\n    VCT_CLK(5);\n"),
        ("  consumers_sync(cbar, cs, &syncs);  // every CTA holds y2\n",
         "  VCT_CLK(6);\n  consumers_sync(cbar, cs, &syncs);  // every CTA holds y2\n  VCT_CLK(7);\n"),
        ("pix_addr, nkc, a.HX, a.yrow);\n",
         "pix_addr, nkc, a.HX, a.yrow);\n      const unsigned long long e0 = clock64();\n"),
        ("        mbar_wait<false>(rbar, rphase);\n",
         "        const unsigned long long w0 = clock64();\n        mbar_wait<false>(rbar, rphase);\n"
         "        ew += clock64() - w0;\n"),
        ("        fence_proxy_async();\n        asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kConsumers) : \"memory\");\n",
         "        fence_proxy_async();\n        const unsigned long long s0 = clock64();\n"
         "        asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kConsumers) : \"memory\");\n"
         "        es += clock64() - s0;\n"),
        ("          bulk_commit();\n        }\n      }\n    }\n",
         "          bulk_commit();\n        }\n      }\n      et += clock64() - e0;\n    }\n"),
        ("    if (threadIdx.x == 0) bulk_wait<false>();  // the stores are done before the CTA exits\n",
         "    if (threadIdx.x == 0) bulk_wait<false>();  // the stores are done before the CTA exits\n"
         "    VCT_CLK(8);\n"
         "    if (threadIdx.x == 0) { g_clk[9][blockIdx.x] = ew; g_clk[10][blockIdx.x] = es;"
         " g_clk[11][blockIdx.x] = et; }\n"),
    ),
    "(g) no copies (timing only)": (
        ("mbar_expect_tx(&full[s], a.xbytes + a.wbytes);", "mbar_expect_tx(&full[s], 0);"),
        ("        mbar_expect_tx(&full[s], a.wbytes);\n        mh = &maps.w2",
         "        mbar_expect_tx(&full[s], 0);\n        mh = &maps.w2"),
        ("        mbar_expect_tx(&full[s], a.wbytes);\n        mh = &maps.w3",
         "        mbar_expect_tx(&full[s], 0);\n        mh = &maps.w3"),
        ("          tma_4d(slot,", "          if (false) tma_4d(slot,"),
        ("          tma_4d_multicast(slot,", "          if (false) tma_4d_multicast(slot,"))
    + _NO_TMA,
}

# Appended to every variant: the plan, its clusters, the card's active
# clusters for the kernel the launcher picks, the cost model's clocks.
ENTRY = """
template <typename T, int MT1, int MT2>
static cudaError_t probe_active(const Plan& p, int items, size_t smem, int* active, int* regs) {
  auto kernel = fused_bottleneck_kernel<T, true, MT1, MT2>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(items) * p.cs);
  cfg.blockDim = dim3(kAll);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) *regs = a.numRegs;
  return e;
}

template <typename T>
static int probe_plan(int B, int H, int W, int C, int Cm, double* out) {
  int dev = 0, sms = 0, clk = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = pick_plan<T>(B, H, W, C, Cm, sms);
  if (p.cs == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(p, H, W);
  const int items = ceil_div(B, p.ni) * ceil_div(H, p.ty) * ceil_div(W, p.tx);
  const int mt1 = mt_of(rows1(p, H, W)), mt2 = mt_of(rows2(p));
  int active = 0, regs = 0;
  if (mt1 == 1) {
    e = mt2 == 1 ? probe_active<T, 1, 1>(p, items, smem, &active, &regs)
                 : probe_active<T, 1, 2>(p, items, smem, &active, &regs);
  } else {
    e = mt2 == 1 ? probe_active<T, 2, 1>(p, items, smem, &active, &regs)
                 : probe_active<T, 2, 2>(p, items, smem, &active, &regs);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const double cost = plan_cost<T>(p, B, H, W, C, Cm, sms);
  const double vals[] = {static_cast<double>(p.cs), static_cast<double>(p.ni),
                         static_cast<double>(p.ty), static_cast<double>(p.tx),
                         static_cast<double>(smem), static_cast<double>(items * p.cs),
                         static_cast<double>(items), static_cast<double>(active),
                         static_cast<double>(active > 0 ? (items + active - 1) / active : 0),
                         cost, static_cast<double>(clk), static_cast<double>(sms),
                         static_cast<double>(regs), static_cast<double>(mt1),
                         static_cast<double>(mt2)};
  for (int i = 0; i < 15; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int vct_probe_plan(int f32, int B, int H, int W, int C, int Cm, double* out) {
  return f32 ? probe_plan<float>(B, H, W, C, Cm, out)
             : probe_plan<__nv_bfloat16>(B, H, W, C, Cm, out);
}
"""
CAP_ENTRY = """
extern "C" void vct_probe_cap(int cap) { g_probe_cap = cap; }
"""
PLAN_KEYS = ("cluster", "images", "tile_h", "tile_w", "smem_bytes", "ctas", "clusters",
             "active_clusters", "waves", "cost_clocks", "clock_khz", "sms", "registers", "mt1",
             "mt2")


def source(tree: Path, edits: tuple) -> str:
    """``tree``'s csrc/fused_bottleneck.cu with tf32x3.cuh pasted in (the
    copy is built outside its directory), ``edits`` applied and the probe's
    entries appended."""
    csrc = tree / "video_captioning_tpu_torch" / "csrc"
    src = (csrc / "fused_bottleneck.cu").read_text().replace(
        '#include "tf32x3.cuh"', (csrc / "tf32x3.cuh").read_text())
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_bottleneck.cu of {tree} no longer matches the probe's "
                               f"edit of {old[:60]!r}")
        src = src.replace(old, new)
    return src + ENTRY + (CAP_ENTRY if "g_probe_cap" in src else "")


CLOCK_ENTRY = """
extern "C" int vct_probe_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));
}
"""
# (j)'s readings (thread 0 of each CTA, CTA means): phase 1's k-loop, its
# epilogue, the barrier after it, phase 2's k-loop, the barrier before its
# stores (the other warps' k-loops), its stores, the barrier after them,
# phase 3, and within phase 3's epilogues: waiting for the residual, at the
# barrier before the stores, in all.
CLOCK_PARTS = ("phase 1 k-loop", "phase 1 epilogue", "barrier 1", "phase 2 k-loop",
               "barrier 2", "phase 2 stores", "barrier 3", "phase 3")
CLOCK_SUMS = ("phase 3 residual wait", "phase 3 barrier", "phase 3 epilogues")


def clock_parts(lib: ctypes.CDLL, ctas: int) -> dict:
    buf = (ctypes.c_ulonglong * (16 * 4096))()
    lib.vct_probe_clocks.argtypes = [ctypes.c_void_p]
    rc = lib.vct_probe_clocks(buf)
    if rc != 0:
        raise RuntimeError(f"vct_probe_clocks: {lib.vct_error_string(rc).decode()}")
    c = [[buf[k * 4096 + i] for i in range(ctas)] for k in range(12)]
    out = {name: sum(c[k + 1][i] - c[k][i] for i in range(ctas)) / ctas
           for k, name in enumerate(CLOCK_PARTS)}
    out.update({name: sum(c[9 + k]) / ctas for k, name in enumerate(CLOCK_SUMS)})
    return out


def this_source(edits: tuple) -> str:
    """This tree's csrc/fused_bottleneck.cu with tf32x3.cuh pasted in and
    ``edits`` applied (and, with g_clk, the entry that reads it)."""
    csrc = Path(__file__).resolve().parent / "video_captioning_tpu_torch" / "csrc"
    src = (csrc / "fused_bottleneck.cu").read_text().replace(
        '#include "tf32x3.cuh"', (csrc / "tf32x3.cuh").read_text())
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"this tree's fused_bottleneck.cu no longer matches the probe's "
                               f"edit of {old[:60]!r}")
        src = src.replace(old, new)
    return src + (CLOCK_ENTRY if "g_clk" in src else "")


def probe_this(card: str) -> list:
    """THIS_VARIANTS through this tree's wrapper at the four stages."""
    from chip_smoke import _rel_err
    from video_captioning_tpu_torch.ops import bottleneck as bmod

    with ThreadPoolExecutor(len(THIS_VARIANTS)) as pool:
        futures = {name: pool.submit(build_variant, f"probe_bottleneck_this_{i}",
                                     this_source(edits))
                   for i, (name, edits) in enumerate(THIS_VARIANTS.items())}
        builds = {name: f.result() for name, f in futures.items()}
    for name, (_, report) in builds.items():
        print(f"[probe] {name}: ptxas {ptxas(report, 'fused_bottleneck_kernel')}")
    load = bmod.load_library
    results = []
    try:
        for stage, (H, C, Cm) in enumerate(RESNET_STAGES, start=1):
            for dtype in (torch.float32, torch.bfloat16):
                x, ws = bottleneck_inputs("cuda", 32, H, H, C, Cm, dtype, seed=41 + stage)
                row = {"stage": stage, "dtype": str(dtype)[6:], "plan": bmod.card_plan(x, Cm),
                       "ms": {}}
                for name, (lib, _) in builds.items():
                    bmod.load_library = lambda *a, lib=lib, **k: lib
                    if name == "this tree's design (probe build)":
                        row["err"] = _rel_err(bmod.fused_bottleneck(x, *ws),
                                              bmod.fused_bottleneck_reference(x, *ws))
                    row["ms"][name] = _graph_ms(torch, lambda: bmod.fused_bottleneck(x, *ws))
                    if name.startswith("(j)"):
                        bmod.fused_bottleneck(x, *ws)
                        torch.cuda.synchronize()
                        row["clocks"] = clock_parts(lib, row["plan"]["ctas"])
                results.append(row)
                print(f"[probe] this tree, stage {stage} {row['dtype']}: plan {row['plan']}; "
                      f"error {row['err']:.3g}; device ms (graph replay) "
                      + ", ".join(f"{k}: {v:.4f}" for k, v in row["ms"].items()) + f" ({card})",
                      flush=True)
                print(f"[probe]   (j)'s CTA-mean clocks: "
                      + ", ".join(f"{k} {v:.0f}" for k, v in row["clocks"].items()), flush=True)
    finally:
        bmod.load_library = load
    return results


def probe_plans(card: str, n: int) -> list:
    """This tree's kernel at each stage under its first n candidate plans."""
    from chip_smoke import _rel_err
    from video_captioning_tpu_torch.ops import bottleneck as bmod

    card_plan = bmod.card_plan
    results = []
    try:
        for stage, (H, C, Cm) in enumerate(RESNET_STAGES, start=1):
            for dtype in (torch.float32, torch.bfloat16):
                x, ws = bottleneck_inputs("cuda", 32, H, H, C, Cm, dtype, seed=41 + stage)
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                plans = bmod.plan_candidates(32, H, H, C, Cm, dtype, sms,
                                             bmod.active_clusters(0, dtype))[:n]
                for plan in plans:
                    bmod.card_plan = lambda *a, plan=plan: plan
                    err = _rel_err(bmod.fused_bottleneck(x, *ws),
                                   bmod.fused_bottleneck_reference(x, *ws))
                    ms = _graph_ms(torch, lambda: bmod.fused_bottleneck(x, *ws))
                    results.append({"stage": stage, "dtype": str(dtype)[6:], "plan": plan,
                                    "err": err, "ms": ms})
                    print(f"[plans] stage {stage} {str(dtype)[6:]}: "
                          + " ".join(f"{k}={plan[k]}" for k in bmod.PLAN_KEYS)
                          + f" ctas={plan['ctas']} waves={plan['waves']}: estimate "
                          f"{plan['cost_clocks']:.0f} clocks, device {ms:.4f} ms, error "
                          f"{err:.3g} ({card})", flush=True)
    finally:
        bmod.card_plan = card_plan
    return results


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"vct_fused_bottleneck_{dt}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vct_probe_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.vct_probe_plan.restype = ctypes.c_int
    lib.vct_error_string.argtypes = [ctypes.c_int]
    lib.vct_error_string.restype = ctypes.c_char_p
    return lib


def launcher(lib: ctypes.CDLL, x: torch.Tensor, ws: list):
    """One launch of the variant's C entry on the current stream."""
    fn = getattr(lib, "vct_fused_bottleneck_" + ("f32" if x.dtype == torch.float32 else "bf16"))
    out = torch.empty_like(x)
    B, H, W, C = x.shape
    args = (x.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), B, H, W, C,
            ws[0].shape[0])

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_bottleneck variant: {lib.vct_error_string(rc).decode()}")
    return call, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other checkout's root")
    ap.add_argument("--this", action="store_true", help="probe this tree's kernel")
    ap.add_argument("--plans", type=int, default=0, help="time this tree's first N plans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_bottleneck: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = card_line()
    if args.plans:
        results = probe_plans(card, args.plans)
        print(card)
        print(json.dumps({"card": card, "plans": results}))
        return 0
    if args.this:
        results = probe_this(card)
        print(card)
        print(json.dumps({"card": card, "this": results}))
        return 0
    if args.other is None:
        ap.error("--other or --this is required")
    other = args.other.resolve()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {name: pool.submit(build_variant, f"probe_bottleneck_{i}", source(other, edits))
                   for i, (name, edits) in enumerate(VARIANTS.items())}
        builds = {name: (typed(f.result()[0]), f.result()[1]) for name, f in futures.items()}
    for name, (_, report) in builds.items():
        print(f"[probe] {name}: ptxas {ptxas(report, 'fused_bottleneck_kernel')}")
    results = []
    for stage, (H, C, Cm) in enumerate(RESNET_STAGES, start=1):
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            x, ws = bottleneck_inputs("cuda", 32, H, H, C, Cm, dtype, seed=41 + stage)
            base_lib = builds["the checkout's design"][0]
            vals = (ctypes.c_double * len(PLAN_KEYS))()
            rc = base_lib.vct_probe_plan(int(f32), 32, H, H, C, Cm, vals)
            if rc != 0:
                raise RuntimeError(f"vct_probe_plan: {base_lib.vct_error_string(rc).decode()}")
            plan = dict(zip(PLAN_KEYS, (int(v) if v == int(v) else v for v in vals)))
            plan["estimate_ms"] = plan["cost_clocks"] / plan["clock_khz"]
            row = {"stage": stage, "dtype": str(dtype)[6:], "plan": plan, "ms": {}}
            for name, (lib, _) in builds.items():
                if "g_probe_cap" in source(other, VARIANTS[name]):
                    lib.vct_probe_cap.argtypes = [ctypes.c_int]
                    lib.vct_probe_cap(plan["active_clusters"])
                call, _ = launcher(lib, x, ws)
                row["ms"][name] = _graph_ms(torch, call)
            results.append(row)
            print(f"[probe] stage {stage} {row['dtype']} (B=32, {H}x{H}, C={C}, Cm={Cm}): plan "
                  f"{plan}; estimate {plan['estimate_ms']:.4f} ms at {plan['clock_khz']} kHz; "
                  f"device ms (graph replay) "
                  + ", ".join(f"{k}: {v:.4f}" for k, v in row["ms"].items()) + f" ({card})",
                  flush=True)
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
