"""The main path's recurrence kernels on one card, split into their parts
by variants of another checkout's design, beside that checkout's and this
tree's own builds:

    python3 probe_lstm.py --other DIR [--rounds 2]

``DIR`` holds another checkout (for example the parent commit unpacked
with ``git archive`` into the gitignored ``_scratch/``). Each variant is
that checkout's ``csrc/lstm_seq.cu`` or ``csrc/lstm_seq_train.cu``, with
``lstm_seq_fwd.cuh`` pasted in, edited as text (``FWD_VARIANTS``,
``DW_VARIANTS``; an edit that no longer matches fails by name), with an
entry appended that reports the kernel's CTAs an SM, registers and local
bytes, and built into the gitignored ``_build/`` (one ``nvcc`` each, all
started together; ptxas's registers and spills are read from its log).

* The narrow forward (``lstm_seq``, H = 512, float32 xproj) at
  (80, 2, 128, 2048) and (80, 2, 32, 2048): (a) a step with no products
  (the exchange, the barrier and the gate math), (b) products and gate
  math on stale h (no copies of h, no counter wait, no publish), (c) the
  barrier alone (no copies, no products), (d) ``FwdWide``'s tile (16 units
  and 16 warps a CTA, one CTA an SM, the mbarrier ring) at H = 512. Each
  is timed by CUDA-graph replay at T = 80 and T = 1 (a step's time is
  their difference over 79).
* dW_hh (``lstm_seq_train_bwd``'s product launches) at B = 32 and 128
  (H = 512) and at B = 32, H = 1024: (e) the reduction in one part (no
  split, no sum launch), (f) operands read as bfloat16 (pre-cast: half
  the bytes), (g) the loads and shared-memory stores without products;
  and this tree's own launch with stages of 32 rows (``DW_THIS_VARIANTS``,
  through this tree's wrapper). Each is timed by the profiler inside a
  backward call (the kernels whose names hold ``lstm_seq_dw``; the sweep's
  beside it), beside one bf16 ``bmm`` of the same product
  (``chip_smoke.dw_library_call``).

Variants marked "timing only" need not be correct; every other one must
give the other checkout's bits (the forward's outputs; dW_hh of (e) is
reported by its error against the other's, since the split sets the sum's
order). Every build is timed in turns (other, this tree, the variants,
then back, ``--rounds`` times). Prints each build's times, registers,
local bytes and CTAs an SM beside the card's name and power limit, and a
JSON line last. Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import device_ms, dw_library_call, lstm_inputs
from compare_attention import _graph_ms
from compare_lstm import DW_RTOL
from video_captioning_tpu_torch.ops import build

# The modules (the package exports functions of the same names).
seq = importlib.import_module("video_captioning_tpu_torch.ops.lstm_seq")
train = importlib.import_module("video_captioning_tpu_torch.ops.lstm_seq_train")

FWD_SHAPES = ((80, 2, 128, 512), (80, 2, 32, 512))  # (T, ND, B, H)
DW_SHAPES = ((80, 2, 32, 512), (80, 2, 128, 512), (80, 2, 32, 1024))

_MMA = """            uint32_t a[4];
            ldmatrix_x4(a, hb + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * hstride +
                               kt * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < Tile::kNt; ++nt)
              mma_bf16(acc[nt], a, wf[i][nt][0], wf[i][nt][1]);
"""
_NO_MMA = "            acc[0][0] += __bfloat162float(hb[(mi * 16 + g) * hstride + kt * 16 + tq]);\n"
_COPIES = ("      for (int e = tid; e < rows * vecs; e += kThreads) {\n"
           "        const int r = e / vecs;")
_NO_COPIES = "      for (int e = tid; false; e += kThreads) {\n        const int r = e / vecs;"
# name: (old, new) text edits of lstm_seq.cu with lstm_seq_fwd.cuh pasted in.
FWD_VARIANTS = {
    "kept design (probe build)": (),
    "(a) no products: exchange, barrier, gate math (timing only)": ((_MMA, _NO_MMA),),
    "(b) products and gate math on stale h: no copies, wait or publish (timing only)": (
        (_COPIES, _NO_COPIES),
        ("      if (tid == 0) dir_wait(counter, static_cast<unsigned>(t * unit_groups));\n", ""),
        ("      if (tid == 0) dir_arrive(counter);\n", ""),
        ("        if (t + 1 < p.T) {\n          __stcg(",
         "        if (false) {\n          __stcg(")),
    "(c) the barrier alone: no copies, no products (timing only)": (
        (_MMA, _NO_MMA), (_COPIES, _NO_COPIES)),
    "(d) FwdWide's tile at H = 512": (
        ("  if (H <= kMaxHidden) {\n    return launch_recurrence(&lstm_seq_fwd_kernel",
         "  if (H <= 0) {\n    return launch_recurrence(&lstm_seq_fwd_kernel"),),
}
_PRODUCTS = """#pragma unroll
    for (int ks = 0; ks < kDwK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A = h^T: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
        // (m 8-15, k 8-15) of the [q][k] tile, each transposed.
        ldmatrix_x4_trans(a[mi], &as[st][ks + (lane & 7) + (lane >> 4) * 8]
                                    [wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8]);
      }
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t bf[4];  // b0, b1 of n-tiles 2 pair and 2 pair + 1
        ldmatrix_x4_trans(bf, &bs[st][ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [wn * 64 + pair * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * pair], a[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * pair + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
"""
# name: (old, new) text edits of lstm_seq_train.cu with lstm_seq_fwd.cuh pasted in.
DW_VARIANTS = {
    "kept design (probe build)": (),
    "(e) splits = 1": (("  return splits < 1 ? 1 : splits;\n}", "  return 1;\n}"),),
    "(f) operands read as bfloat16 (timing only)": (
        ("  Raw8<float> va;\n  Raw8<T> vb0, vb1;",
         "  Raw8<__nv_bfloat16> va;\n  Raw8<__nv_bfloat16> vb0, vb1;"),
        ("        va.load(h_keep + ",
         "        va.load(reinterpret_cast<const __nv_bfloat16*>(h_keep) + "),
        ("        const T* src = dxproj + ",
         "        const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(dxproj) + ")),
    "(g) loads without products (timing only)": (
        (_PRODUCTS, "    acc[0][0][0] += __bfloat162float(as[st][lq][la]) + "
                    "__bfloat162float(bs[st][lq][lb]);\n"),),
}
# name: ((old, new) text edits of this tree's lstm_seq_train.cu (its dW_hh
# launch), the plan's constants in ops/lstm_seq_train.py to match), timed
# through this tree's wrapper.
DW_THIS_VARIANTS = {
    "this tree, stages of 32 rows, a ring of 6": (
        (("constexpr int kDwK = 64;", "constexpr int kDwK = 32;"),
         ("constexpr int kDwRing = 3;", "constexpr int kDwRing = 6;")),
        dict(DW_K=32, DW_MIN_STEPS=8)),
}
# Appended to every variant of the other checkout: CTAs an SM, registers and local bytes of the
# float32 forward kernel (narrow or FwdWide tile, its shared memory at nb
# rows and `ring` slots) or of the float32 dW_hh kernel.
FWD_ENTRY = """
template <typename Tile>
static int probe_fwd(int H, int nb, int ring, int* out) {
  auto kernel = vct::lstm_seq_fwd_kernel<float, false, Tile>;
  const size_t smem = vct::fwd_smem_bytes<Tile>(H, nb, ring);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(vct::kMaxSmem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, Tile::kThreads, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) {
    out[1] = a.numRegs;
    out[2] = static_cast<int>(a.localSizeBytes);
    out[3] = static_cast<int>(smem);
  }
  return static_cast<int>(e);
}
extern "C" int vct_probe_kernel(int wide, int H, int nb, int ring, int* out) {
  return wide ? probe_fwd<vct::FwdWide>(H, nb, ring, out)
              : probe_fwd<vct::FwdNarrow>(H, nb, ring, out);
}
"""
DW_ENTRY = """
extern "C" int vct_probe_kernel(int, int, int, int, int* out) {
  auto kernel = vct::lstm_seq_dw_kernel<float>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(vct::kDwSmem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, vct::kDwThreads, vct::kDwSmem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) {
    out[1] = a.numRegs;
    out[2] = static_cast<int>(a.localSizeBytes);
    out[3] = static_cast<int>(vct::kDwSmem);
  }
  return static_cast<int>(e);
}
"""


def source(tree: Path, name: str, edits: tuple = ()) -> str:
    """``tree``'s csrc/<name>.cu with lstm_seq_fwd.cuh pasted in and
    ``edits`` applied."""
    csrc = tree / "video_captioning_tpu_torch" / "csrc"
    src = (csrc / f"{name}.cu").read_text().replace(
        '#include "lstm_seq_fwd.cuh"', (csrc / "lstm_seq_fwd.cuh").read_text())
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}.cu of {tree} no longer matches the probe's edit of "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variant(stem: str, src: str) -> tuple:
    """``src`` built once into ``_build/`` by its hash and loaded, with the
    ptxas report (``-Xptxas -v``) kept beside it: (library, report)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{stem}_{hashlib.sha256(src.encode()).hexdigest()[:16]}"
    cu, so, log = (build.BUILD_DIR / f"{stem}{ext}" for ext in (".cu", ".so", ".log"))
    if not so.exists():
        cu.write_text(src)
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}:\n{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(so)), log.read_text() if log.exists() else ""


def ptxas(report: str, match: str) -> dict:
    """The most registers, stack bytes and spill-store bytes ptxas reported
    for the kernels whose mangled names contain ``match``."""
    regs, stack, spill, name = 0, 0, 0, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name is not None and match in name:
            if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line):
                stack, spill = max(stack, int(m.group(1))), max(spill, int(m.group(2)))
            if m := re.search(r"Used (\d+) registers", line):
                regs = max(regs, int(m.group(1)))
    return dict(registers=regs, stack_bytes=stack, spill_bytes=spill)


def typed(lib: ctypes.CDLL, which: str) -> ctypes.CDLL:
    """The argument types of the other checkout's entries (the forward's
    are this tree's too; its backward's are ``other_bwd``'s)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if which == "fwd":
        lib.vct_lstm_seq.argtypes = [p, i] + [p] * 7 + [i] * 5 + [p]
        lib.vct_lstm_seq.restype = i
        limits = (lib.vct_lstm_seq_max_hidden, lib.vct_lstm_seq_narrow_max_hidden)
    else:
        lib.vct_lstm_seq_train_fwd.argtypes = [p, i] + [p] * 10 + [i] * 5 + [p]
        lib.vct_lstm_seq_train_fwd.restype = i
        lib.vct_lstm_seq_train_bwd.argtypes = [p, i] + [p] * 12 + [i] * 5 + [p]
        lib.vct_lstm_seq_train_bwd.restype = i
        lib.vct_lstm_seq_train_dw_splits.argtypes = [i] * 4
        lib.vct_lstm_seq_train_dw_splits.restype = i
        limits = (lib.vct_lstm_seq_train_max_hidden, lib.vct_lstm_seq_train_narrow_max_hidden)
    for limit in limits:
        limit.argtypes = []
        limit.restype = i
    if hasattr(lib, "vct_probe_kernel"):
        lib.vct_probe_kernel.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        lib.vct_probe_kernel.restype = i
    return lib


def libraries(other: Path) -> dict:
    """{"fwd" | "dw": {build name: (library, ptxas report)}}: the other
    checkout's builds, this tree's (the package's own build) and every
    variant, built in parallel."""
    here = Path(__file__).resolve().parent
    def this(name):  # typed by the wrapper module itself
        return (seq if name == "lstm_seq" else train)._kernel_lib(), None

    jobs = {("fwd", "other"): lambda: build_variant("other_lstm_seq", source(other, "lstm_seq")),
            ("fwd", "this tree"): lambda: this("lstm_seq"),
            ("dw", "other"): lambda: build_variant("other_lstm_seq_train",
                                                   source(other, "lstm_seq_train")),
            ("dw", "this tree"): lambda: this("lstm_seq_train")}
    for name, edits in FWD_VARIANTS.items():
        jobs[("fwd", name)] = lambda e=edits: build_variant(
            "probe_fwd", source(other, "lstm_seq", e) + FWD_ENTRY)
    for name, edits in DW_VARIANTS.items():
        jobs[("dw", name)] = lambda e=edits: build_variant(
            "probe_dw", source(other, "lstm_seq_train", e) + DW_ENTRY)
    for name, (edits, _) in DW_THIS_VARIANTS.items():
        jobs[("dw", name)] = lambda e=edits: build_variant(
            "probe_dw_this", source(here, "lstm_seq_train", e))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(fn) for key, fn in jobs.items()}
        out = {"fwd": {}, "dw": {}}
        for (which, name), f in futures.items():
            lib, report = f.result()
            mine = name.startswith("this tree")
            out[which][name] = (train._typed(lib) if mine and name != "this tree" else
                                lib if mine else typed(lib, which), report)
        return out


def narrow_rows(B: int, ND: int, H: int, ctas_an_sm: int = 2, sms: int = 132) -> int:
    """Rows a narrow forward CTA takes (launch_recurrence: the most row
    groups of at least 16 rows whose CTAs of 8 units are co-resident)."""
    ug = H // 8
    for g in range(max(1, B // 16), 0, -1):
        if ND * g * ug <= ctas_an_sm * sms:
            return -(-B // g)
    return B


def facts(lib: ctypes.CDLL, report, which: str, name: str, B: int, H: int) -> dict:
    """CTAs an SM, registers, local bytes and shared memory of the build's
    kernel (its probe entry), and ptxas's registers and spills; ptxas's
    alone for a build without the entry."""
    # The other checkout's narrow tile is FwdTile<8, ...>; (d) and this
    # tree's forward take FwdTile<16, ...>.
    fwd = "FwdTileILi16E" if name.startswith("(d)") or name == "this tree" else "FwdTileILi8E"
    match = {"fwd": fwd, "dw": "lstm_seq_dw_kernel"}[which]
    if report is None:  # this tree's build: the package's own log
        report = build.build_logs.get("lstm_seq" if which == "fwd" else "lstm_seq_train", "")
    res = {"ptxas": ptxas(report, match)}
    if hasattr(lib, "vct_probe_kernel"):
        wide = name.startswith("(d)")
        if wide:
            plan = seq.fwd_wide_plan(H, B)
            nb, ring = plan["nb"], plan["ring"]
        else:
            nb, ring = narrow_rows(B, 2, H), 0
        out = (ctypes.c_int * 4)()
        rc = lib.vct_probe_kernel(int(wide), H, nb, ring, out)
        if rc != 0:
            raise RuntimeError(f"{name}: vct_probe_kernel failed ({rc})")
        res.update(ctas_an_sm=out[0], registers=out[1], local_bytes=out[2], smem=out[3])
    return res


def use(lib: ctypes.CDLL, name: str, which: str) -> None:
    """Route the wrapper module's launches to ``lib``; (d) also takes the
    wide plan's ring at H = 512."""
    mod = seq if which == "fwd" else train
    mod._kernel_lib = lambda: lib
    wide = name.startswith("(d)")
    ring = (lambda H, B, ND: seq.fwd_wide_plan(H, B, ND)["ring"]) if wide else _FWD_RING
    seq.fwd_ring = train.fwd_ring = ring


_FWD_RING = seq.fwd_ring


def probe_fwd(libs: dict, rounds: int) -> dict:
    """Every forward build at FWD_SHAPES: bits against the other's, graph
    replay at T = 80 and T = 1, in turns."""
    result = {}
    for T, ND, B, H in FWD_SHAPES:
        x, w, m = lstm_inputs("cuda", torch.float32, T=T, ND=ND, B=B, H=H)
        want = None
        for name, (lib, _) in libs.items():
            use(lib, name, "fwd")
            o, (h, c) = seq.lstm_seq(x, w, m)
            got = [t.cpu() for t in (o, h, c)]
            if want is None:
                want = got
            elif "timing only" not in name and not all(map(torch.equal, got, want)):
                raise AssertionError(f"forward B={B}: {name} does not give the other's bits")
        times = {name: {"T80": [], "T1": []} for name in libs}
        order = list(libs)
        x1, m1 = x[:1], m[:, :1].contiguous()
        for _ in range(rounds):
            for name in order + order[::-1]:
                use(libs[name][0], name, "fwd")
                times[name]["T80"].append(_graph_ms(torch, lambda: seq.lstm_seq(x, w, m), calls=3))
                times[name]["T1"].append(_graph_ms(torch, lambda: seq.lstm_seq(x1, w, m1)))
        for name, tm in times.items():
            med = {k: statistics.median(v) for k, v in tm.items()}
            med["step_us"] = (med["T80"] - med["T1"]) / (T - 1) * 1e3
            med.update(facts(*libs[name], "fwd", name, B, H))
            result[f"forward ({T}, {ND}, {B}, {4 * H}): {name}"] = med
            print(f"forward ({T}, {ND}, {B}, {4 * H}) f32: {name}: graph replay "
                  f"{med['T80']:.4f} ms, T = 1 {med['T1']:.4f} ms, {med['step_us']:.3f} us a "
                  f"step; {({k: v for k, v in med.items() if k not in ('T80', 'T1', 'step_us')})}",
                  flush=True)
    return result


def other_bwd(lib: ctypes.CDLL, gact, h_keep, c_keep, w, mask, douts, dh, dc) -> tuple:
    """The other checkout's backward launches (its wrapper's call: the
    sweep, dW_hh in ``splits`` parts, the split sum), float32, on the
    current stream: (dxproj, dW_hh)."""
    T, ND, B, H4 = gact.shape
    H = H4 // 4
    f32 = dict(dtype=torch.float32, device=gact.device)
    gbuf = torch.empty((2, ND, B, H4), dtype=torch.bfloat16, device=gact.device)
    sync = torch.empty((ND, B), dtype=torch.int32, device=gact.device)
    dx, dw = torch.empty_like(gact), torch.empty((ND, H, H4), **f32)
    splits = lib.vct_lstm_seq_train_dw_splits(T, ND, B, H)
    part = torch.empty((splits - 1, ND, H, H4), **f32)
    rc = lib.vct_lstm_seq_train_bwd(
        gact.data_ptr(), 0, h_keep.data_ptr(), c_keep.data_ptr(), w.data_ptr(), mask.data_ptr(),
        douts.data_ptr(), dh.data_ptr(), dc.data_ptr(), gbuf.data_ptr(), sync.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), part.data_ptr() if splits > 1 else None, splits, T, ND, B,
        H, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vct_lstm_seq_train_bwd: CUDA error {rc}")
    return dx, dw


def probe_dw(libs: dict, rounds: int) -> dict:
    """Every dW_hh build at DW_SHAPES inside a backward call: its launches'
    and the sweep's device time by the profiler, in turns; one bf16 bmm of
    the same product beside them."""
    result = {}
    for T, ND, B, H in DW_SHAPES:
        x, w, m = lstm_inputs("cuda", torch.float32, T=T, ND=ND, B=B, H=H)
        res = train.lstm_seq_train_fwd_reference(x, w, m)[3:]
        g = torch.Generator(device="cpu").manual_seed(2)
        douts = torch.randn((T, ND, B, H), generator=g).cuda()
        dh, dc = (torch.randn((ND, B, H), generator=g).cuda() for _ in range(2))

        def call(name):
            lib = libs[name][0]
            if not name.startswith("this tree"):
                return lambda: other_bwd(lib, *res, w, m, douts, dh, dc)

            def mine():  # this tree's wrapper on this build, with its plan's constants
                train._kernel_lib = lambda: lib
                plan = DW_THIS_VARIANTS.get(name, ((), {}))[1]
                kept = {k: getattr(train, k) for k in plan}
                vars(train).update(plan)
                try:
                    return train.lstm_seq_train_bwd(*res, w, m, douts, dh, dc)
                finally:
                    vars(train).update(kept)
            return mine

        want = None
        errs = {}
        for name in libs:
            dx, dw = call(name)()
            if want is None:
                want = (dx.cpu(), dw.cpu())
            if "timing only" not in name:
                if not torch.equal(dx.cpu(), want[0]):
                    raise AssertionError(f"backward B={B} H={H}: {name}: dxproj differs")
                errs[name] = ((dw.cpu() - want[1]).abs().max() / want[1].abs().max()).item()
                if errs[name] > DW_RTOL:
                    raise AssertionError(f"backward B={B} H={H}: {name}: dW_hh {errs[name]:.3g} "
                                         f"from the other's")
        times = {name: {"dw": [], "sweep": []} for name in libs}
        order = list(libs)
        for _ in range(rounds):
            for name in order + order[::-1]:
                times[name]["dw"].append(device_ms(call(name), calls=5, keys=("lstm_seq_dw",)))
                times[name]["sweep"].append(device_ms(call(name), calls=5,
                                                      keys=("lstm_seq_bwd",)))
        tag = f"dW_hh ({T}, {ND}, {B}, {4 * H})"
        bmm = _graph_ms(torch, dw_library_call(res[1], call("this tree")()[0]))
        result[f"{tag}: one bf16 bmm"] = bmm
        print(f"{tag}: one bf16 bmm on pre-cast operands {bmm:.4f} ms (graph replay)", flush=True)
        for name, tm in times.items():
            med = {k: statistics.median(v) for k, v in tm.items()}
            med["dw_rel_err_vs_other"] = errs.get(name)
            med.update(facts(*libs[name], "dw", name, B, H))
            result[f"{tag}: {name}"] = med
            print(f"{tag}: {name}: dW_hh {med['dw']:.4f} ms, sweep {med['sweep']:.4f} ms "
                  f"(profiler); {({k: v for k, v in med.items() if k not in ('dw', 'sweep')})}",
                  flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2, help="passes there and back")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_lstm: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = libraries(args.other.resolve())
    kept = seq._kernel_lib, train._kernel_lib
    try:
        result = probe_fwd(libs["fwd"], args.rounds)
        result.update(probe_dw(libs["dw"], args.rounds))
    finally:
        seq._kernel_lib, train._kernel_lib = kept
        seq.fwd_ring = train.fwd_ring = _FWD_RING
    print(card)
    print(json.dumps({"card": card, "median_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
