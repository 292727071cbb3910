"""Where the time of another checkout's int8 1x1-conv pair goes, on one card:
each forward shape under each tile, a sweep of K, a smaller M, and cold
operands.

    python3 probe_int8.py --other DIR

``DIR`` holds another checkout (for example the parent commit unpacked with
``git archive`` into the gitignored ``_scratch/``). Its
``csrc/int8_matmul.cu`` is built as it is into the gitignored ``_build/``
and called through its own C entry (``vct_int8_matmul_requant``, whose
``tile`` argument takes -1 for the launcher's choice, 0 for 64 x 64 and 1
for 128 x 64 tiles); nothing of the checkout is edited. At each of the 17
shapes of ``chip_smoke.INT8_FORWARD_SHAPES``, on ``chip_smoke.int8_inputs``
(seed 62), it times by CUDA-graph replay (``compare_attention._graph_ms``:
ten launches a graph, median of 5):

* the launcher's choice, and each tile forced;
* the same (M, N) at K = 64, 128, 256, ... up to the shape's K, under the
  launcher's choice; a least-squares line through those points gives the
  cost of 128 bytes of K (the slope) and of the rest (the intercept: the
  epilogue, the launch, the ring's fill);
* M / 2 and M / 4 at the same K and N (fewer tiles, fewer waves);
* the operands cold in L2: copies of xq (and idq) that together exceed the
  50 MB L2, one a launch;
* ``torch._int_mm`` on the same operands (no epilogue, int32 out).

With ``--this``, the same 17 shapes run through this tree's wrapper, under
the plan ``int8_plan`` picks, on variants of this tree's
``csrc/int8_matmul.cu`` edited as text (``THIS_VARIANTS``; an edit that no
longer matches fails by name), each built into ``_build/`` and loaded in
place of the wrapper's library: the design as it is, (a) no products,
(b) no epilogue arithmetic (the staging stored as it stands), (c) no
stores of the output, each timing only but the first.

With ``--fit FILE``, no card is needed: FILE holds the output of
``chip_smoke.check_int8_matmul`` (its forward-shape lines list every plan
the launcher weighs, forced in turn, with its time), and the constants of
``ops/int8_matmul.py:plan_cost`` named in ``FIT_CONSTANTS`` are fitted to
those times (least squares of the log ratio, Nelder-Mead), printed with
the plan each shape would then pick beside the fastest one measured.

Prints one line a shape beside its bound (``chip_smoke._int8_bound``), the
card's name and power limit, and a JSON line last. Needs a CUDA card and
``nvcc`` but for ``--fit``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import INT8_FORWARD_SHAPES, _int8_bound, card_line, cold_copies, int8_inputs
from compare_attention import _graph_ms
from probe_lstm import build_variant, ptxas

S_OUT, S_ID = 0.1, 0.03

# name: (old, new) text edits of this tree's csrc/int8_matmul.cu.
THIS_VARIANTS = {
    "this tree's design (probe build)": (),
    "(a) no products (timing only)": (
        ("          wgmma_s8(acc, wgmma_desc(sa + ks * 32), wgmma_desc(sb + ks * 32), "
         "kk > 0 || ks > 0);\n", ""),),
    "(b) no epilogue arithmetic (timing only)": (
        ("      uint32_t inexact = 0;  // bit i / 2: the pair d[i], d[i + 1] has an output near a "
         "tie\n#pragma unroll\n",
         "      uint32_t inexact = 0;  // bit i / 2: the pair d[i], d[i + 1] has an output near a "
         "tie\n      if (a.relu == 12345)\n#pragma unroll\n"),),
    "(c) no stores of the output (timing only)": (
        ("            *reinterpret_cast<int4*>(dst) = ",
         "            if (a.relu == 12345) *reinterpret_cast<int4*>(dst) = "),),
}


def other_library(tree: Path) -> tuple:
    """The other checkout's int8 source, built as it is: (library, ptxas)."""
    src = (tree / "video_captioning_tpu_torch" / "csrc" / "int8_matmul.cu").read_text()
    lib, report = build_variant("probe_int8_other", src)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vct_int8_matmul_requant.argtypes = [p] * 5 + [f] * 2 + [p] + [i] * 6 + [p]
    lib.vct_int8_matmul_requant.restype = i
    lib.vct_error_string.argtypes = [i]
    lib.vct_error_string.restype = ctypes.c_char_p
    return lib, ptxas(report, "int8_matmul_kernel")


def caller(lib, name: str, M: int, K: int, N: int, int8_out: bool, tile: int):
    """A call of the other checkout's C entry on seeded operands: (call,
    operands, output)."""
    xq, wq, scale, bias, idq = int8_inputs("cuda", M, K, N, seed=62)
    out = torch.empty((M, N), dtype=torch.int8 if int8_out else torch.float32, device="cuda")
    residual = name == "residual"

    def call(x=xq, idq_=idq):
        rc = lib.vct_int8_matmul_requant(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            idq_.data_ptr() if residual else None, S_ID, S_OUT, out.data_ptr(), M, K, N, 1,
            int(int8_out), tile, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"int8 {name} ({M}, {K}, {N}) tile {tile}: CUDA error {rc} "
                               f"({lib.vct_error_string(rc).decode()})")
    return call, (xq, wq, idq), out


def line_fit(points: list) -> tuple:
    """(intercept, slope) of the least-squares line through (x, y) points."""
    n = len(points)
    mx = sum(p[0] for p in points) / n
    my = sum(p[1] for p in points) / n
    sxx = sum((p[0] - mx) ** 2 for p in points)
    slope = sum((p[0] - mx) * (p[1] - my) for p in points) / sxx if sxx else 0.0
    return my - slope * mx, slope


def probe_shape(lib, name: str, M: int, K: int, N: int, int8_out: bool, sms: int) -> dict:
    res = {"shape": [name, M, K, N, "int8" if int8_out else "float32"],
           "bound_ms": _int8_bound(name, M, K, N, int8_out)["bound_ms"],
           "choice": "128x64" if -(-M // 128) * -(-N // 64) >= sms else "64x64"}
    for tile, label in ((-1, "choice"), (0, "64x64"), (1, "128x64")):
        call, _, _ = caller(lib, name, M, K, N, int8_out, tile)
        res[f"{label}_ms"] = _graph_ms(torch, call)
    call, (xq, wq, idq), _ = caller(lib, name, M, K, N, int8_out, -1)
    res["int_mm_ms"] = _graph_ms(torch, lambda: torch._int_mm(xq, wq.t()))
    xs, ids = cold_copies(xq), cold_copies(idq)
    state = {"i": 0}

    def rotating():
        i = state["i"]
        state["i"] += 1
        call(xs[i % len(xs)], ids[i % len(ids)])
    res["cold_ms"] = _graph_ms(torch, rotating, calls=max(10, len(xs), len(ids)))
    del xs, ids
    sweep = []
    k = 64
    while k <= K:
        c, _, _ = caller(lib, name, M, k, N, int8_out, -1)
        sweep.append((k, _graph_ms(torch, c)))
        k *= 2
    res["k_sweep_ms"] = sweep
    a, b = line_fit([(k / 128, ms) for k, ms in sweep]) if len(sweep) > 1 else (sweep[0][1], 0.0)
    res["k_intercept_ms"], res["k_stage_ms"] = a, b
    for div in (2, 4):
        c, _, _ = caller(lib, name, M // div, K, N, int8_out, -1)
        res[f"m_div{div}_ms"] = _graph_ms(torch, c)
    return res


def edited(src: str, edits: tuple, name: str) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"probe variant {name!r}: its edit no longer matches the source")
        src = src.replace(old, new)
    return src


def probe_this(card: str) -> dict:
    """This tree's kernel and its variants at the 17 shapes, under the
    launcher's plans."""
    from chip_smoke import _int8_calls
    from video_captioning_tpu_torch.ops import build
    from video_captioning_tpu_torch.ops import int8_matmul as im

    src = (build.CSRC_DIR / "int8_matmul.cu").read_text()
    texts = {name: edited(src, edits, name) for name, edits in THIS_VARIANTS.items()}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        libs = dict(zip(texts, pool.map(lambda kv: build_variant("probe_int8_this", kv[1]),
                                        texts.items())))
    out = {}
    for name, (lib, report) in libs.items():
        lib.vct_error_string.argtypes = [ctypes.c_int]
        lib.vct_error_string.restype = ctypes.c_char_p
        im.load_library = lambda stem, defines=(), lib=lib: lib  # noqa: E731
        im.active_ctas.cache_clear()
        im.card_plan.cache_clear()
        total, rows = 0.0, {}
        for kname, M, K, N, int8_out, launches in INT8_FORWARD_SHAPES:
            xq, wq, scale, bias, idq = int8_inputs("cuda", M, K, N, seed=62)
            so = S_OUT if int8_out else None
            fn, ref = _int8_calls(kname, xq, wq, scale, bias, idq, S_ID, so)
            if not out:  # the design as it is: its bits too
                if not torch.equal(fn(), ref()):
                    raise AssertionError(f"probe build {kname} ({M}, {K}, {N}) differs from the "
                                         f"plain version")
            ms = _graph_ms(torch, fn)
            rows[f"{kname} ({M}, {K}, {N}) {'int8' if int8_out else 'float32'}"] = ms
            total += launches * ms
            del xq, wq, scale, bias, idq
        out[name] = {"forward32_ms": total, "shapes": rows,
                     "registers": ptxas(report, "int8_matmul_kernel")}
        print(f"[probe] this tree, {name}: 32 launches {total:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in rows.items()) + f" ({card})", flush=True)
    return out


FIT_CONSTANTS = ("L2_BYTES", "STAGE_LATENCY", "TILE_CLOCKS", "EPI_INT8", "EPI_F32", "EPI_WARPS",
                 "LAUNCH_CLOCKS")
_FORCED = re.compile(r"tile (\d) stages (\d+) grid (\d+) \((\d) an SM, waves \d+, "
                     r"est [\d.]+ us\): ([\d.]+)")


def fit_cost(path: Path) -> dict:
    """Fit plan_cost's FIT_CONSTANTS to the forced-plan times in a
    check_int8_matmul output."""
    import math

    from scipy.optimize import minimize

    from video_captioning_tpu_torch.ops import int8_matmul as im

    points = []
    for line in path.read_text().splitlines():
        m = re.search(r"int8 forward shape: (\S+) \((\d+), (\d+), (\d+)\) (\S+) out", line)
        if not m:
            continue
        shape = (m.group(1) == "residual", *map(int, m.group(2, 3, 4)), m.group(5) == "int8")
        for f in _FORCED.findall(line):
            points.append((shape, *map(int, f[:4]), float(f[4])))

    def cost(shape, tile, stages, grid, per_sm):
        res, M, K, N, i8 = shape
        return im.plan_cost(M, K, N, res, i8, tile, stages, per_sm, grid, 132)

    def err(x):
        for name, v in zip(FIT_CONSTANTS, x):
            setattr(im, name, abs(v))
        return sum(math.log(cost(*p[:5]) / im.CLOCK_GHZ / 1e6 / p[5]) ** 2
                   for p in points) / len(points)

    best = minimize(err, [getattr(im, n) for n in FIT_CONSTANTS], method="Nelder-Mead",
                    options=dict(maxiter=6000, xatol=1e-4, fatol=1e-8))
    fitted = {n: abs(v) for n, v in zip(FIT_CONSTANTS, best.x)}
    err(best.x)
    picks = {}
    for shape in dict.fromkeys(p[0] for p in points):
        rows = [p for p in points if p[0] == shape]
        fastest = min(rows, key=lambda p: p[5])
        pick = min(rows, key=lambda p: cost(*p[:5]))
        picks[str(shape)] = {"fastest": fastest[1:], "picked": pick[1:]}
        print(f"[fit] {shape}: fastest {fastest[1:]}, picked {pick[1:]}")
    out = {"constants": fitted, "rms_log_error": math.sqrt(best.fun), "points": len(points),
           "picks": picks}
    print(f"[fit] {fitted}, rms log error {math.sqrt(best.fun):.3f} over {len(points)} plans")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--this", action="store_true", help="this tree's kernel and its variants")
    ap.add_argument("--fit", type=Path, help="a check_int8_matmul output to fit plan_cost to")
    args = ap.parse_args(argv)
    if args.fit is not None:
        print(json.dumps(fit_cost(args.fit)))
        return 0
    if not torch.cuda.is_available():
        print("probe_int8: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    if args.this:
        res = probe_this(card)
        print(card)
        print(json.dumps({"card": card, "this": res}))
        return 0
    if args.other is None:
        ap.error("--other or --this is required")
    lib, regs = other_library(args.other.resolve())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[probe] {args.other}: int8_matmul_kernel {regs}, {sms} SMs ({card})")
    rows, totals = [], {"choice": 0.0, "64x64": 0.0, "128x64": 0.0, "int_mm": 0.0, "cold": 0.0,
                        "bound": 0.0}
    for name, M, K, N, int8_out, launches in INT8_FORWARD_SHAPES:
        r = probe_shape(lib, name, M, K, N, int8_out, sms)
        r["launches"] = launches
        rows.append(r)
        for key in ("choice", "64x64", "128x64", "int_mm", "cold"):
            totals[key] += launches * r[f"{key}_ms"]
        totals["bound"] += launches * r["bound_ms"]
        sweep = ", ".join(f"K {k}: {ms:.4f}" for k, ms in r["k_sweep_ms"])
        print(f"[probe] {name} ({M}, {K}, {N}) {r['shape'][4]} x{launches}: choice "
              f"{r['choice']} {r['choice_ms']:.4f} ms (64x64 {r['64x64_ms']:.4f}, 128x64 "
              f"{r['128x64_ms']:.4f}), cold {r['cold_ms']:.4f}, torch._int_mm "
              f"{r['int_mm_ms']:.4f}, bound {r['bound_ms']:.4f}; K sweep [{sweep}] -> "
              f"{r['k_stage_ms'] * 1e3:.2f} us a 128-byte K stage + "
              f"{r['k_intercept_ms'] * 1e3:.2f} us; M/2 {r['m_div2_ms']:.4f}, M/4 "
              f"{r['m_div4_ms']:.4f} ({card})", flush=True)
        torch.cuda.empty_cache()
    print(f"[probe] 32 launches: " + ", ".join(f"{k} {v:.4f} ms" for k, v in totals.items())
          + f" ({card})")
    print(card)
    print(json.dumps({"card": card, "registers": regs, "totals": totals, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
