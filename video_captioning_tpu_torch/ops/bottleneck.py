"""One stride-1 identity-residual ResNet bottleneck block, fully fused.

Counterpart of video_captioning_tpu/ops/bottleneck_pallas.py
(fused_bottleneck):

    out = relu(relu(conv3x3(relu(x @ W1^T + b1)) + b2) @ W3^T + b3 + x)

with BN folded into the weights (models/backbones/resnet.py:fold_bn). x is
NHWC (B, H, W, C), float32 or bfloat16; the weights are in torch's (out,
in) layout: ``w1`` (Cm, C), ``w2`` (Cm, Cm, 3, 3) in channels_last memory,
``w3`` (C, Cm); biases (Cm,) / (C,); all of x's dtype. Products accumulate
in float32, and in bfloat16 y1 and y2 are rounded to bfloat16 before the
next product, as the TPU kernel does.

On a CUDA tensor ``fused_bottleneck`` launches the kernel in
``csrc/fused_bottleneck.cu``; on a CPU tensor it runs
``fused_bottleneck_reference``, the plain version (float32 products). The
kernel multiplies on the tensor cores by ``wgmma`` (float32 by a 3xTF32
split: each product within about 2^-21 of the float32 one, float32 sums)
and splits the Cm channels over a thread block cluster of CTAs of 64, 128
or 256 channels each, so on the card Cm is at most 512 (ResNet50's
largest). ``kernel_plan`` picks its work item (whole images or pixel
tiles, so every B, H, W and C is taken: the TPU kernel's ``batch_tile``
VMEM rule has no counterpart here) from the card's SM count and the
clusters it runs at once; the kernel's C entry validates the plan. C and
Cm that are not multiples of 8 are padded with zeros for the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def fused_bottleneck_reference(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                               w3: Tensor, b3: Tensor) -> Tensor:
    """The plain version: float32 products and sums of the operands' values,
    y1 and y2 rounded to x's dtype, output in x's dtype."""
    dt = x.dtype
    xf = x.float()
    y1 = F.relu(F.linear(xf, w1.float(), b1.float())).to(dt)          # (B, H, W, Cm)
    y2 = F.conv2d(y1.float().permute(0, 3, 1, 2), w2.float(), b2.float(), padding=1)
    y2 = F.relu(y2).to(dt).permute(0, 2, 3, 1)                        # (B, H, W, Cm)
    out = F.linear(y2.float(), w3.float(), b3.float()) + xf
    return F.relu(out).to(dt)


def _check(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, w3: Tensor,
           b3: Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"fused_bottleneck takes x (B, H, W, C) float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    C, Cm = x.shape[3], w1.shape[0]
    want = {"w1": (Cm, C), "b1": (Cm,), "w2": (Cm, Cm, 3, 3), "b2": (Cm,), "w3": (C, Cm),
            "b3": (C,)}
    tensors = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, t in tensors.items():
        if tuple(t.shape) != want[name] or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_bottleneck takes {name} {want[name]} {x.dtype} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    fmt = {"w2": torch.channels_last}
    for name, t in (("x", x),) + tuple(tensors.items()):
        if not t.is_contiguous(memory_format=fmt.get(name, torch.contiguous_format)):
            raise ValueError(f"fused_bottleneck takes a contiguous {name}"
                             + (" in channels_last memory" if name in fmt else ""))


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("fused_bottleneck")
    for dt in _DTYPES.values():
        fn = getattr(lib, f"vct_fused_bottleneck_{dt}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    lib.vct_fused_bottleneck_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                         ctypes.c_void_p]
    lib.vct_fused_bottleneck_active_clusters.restype = ctypes.c_int
    return lib


# The kernel's shapes (csrc/fused_bottleneck.cu). A CTA owns SLICES[i]
# channels of y1 and y2 (two warpgroups of half as many columns each), so
# a cluster of ceil(Cm / slice) CTAs shares a work item; the kernel is
# built for the (slice, mb1, mb2) of INSTANCES: mb1 and mb2 blocks of 64
# rows in phase 1 (the x box) and in phases 2-3 (the item's pixels).
MAX_CM = 512
SLICES = (64, 128, 256)
INSTANCES = {
    torch.bfloat16: frozenset({(64, 4, 4), (64, 2, 2), (64, 2, 1), (64, 1, 1), (128, 4, 4),
                               (128, 2, 2), (128, 2, 1), (128, 1, 1), (256, 2, 2), (256, 2, 1),
                               (256, 1, 1)}),
    torch.float32: frozenset({(64, 2, 2), (64, 2, 1), (64, 1, 1), (128, 2, 2), (128, 2, 1),
                              (128, 1, 1), (256, 1, 1)}),
}
MAX_CLUSTER = 8
MAX_STAGES = 8
SMEM_LIMIT = 232448       # a CTA's shared memory on an H100 (227 KB)
HEAD_BYTES = 2048         # the mbarriers and the ring's alignment slack
CHANNEL_ALIGN = 8         # C and Cm as the kernel takes them
MAX_IMAGES = 4            # whole images an item
TILE_SIDES = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 28)

# The cost model (plan_cost), in clocks of an SM, fitted to the kernel's
# clock64() readings on an NVIDIA H100 80GB HBM3 (probe_bottleneck.py
# --this): the tensor cores' dense rate a k-tile reaches (bf16, TF32), the
# least a k-tile takes (the wait for its products, the ring's barriers;
# more in phase 1 with x multicast over a cluster), the bytes a clock from
# device memory and from L2 shared by the CTAs that run at once, an output
# tile's fixed cost a round of boxes and its bytes a clock through shared
# memory, a consumers' barrier (a cluster's grows with its CTAs) and the
# ring's first fill.
MMA_RATE = {torch.bfloat16: 4096 * 0.75, torch.float32: 2048 * 0.75}
KTILE_CLOCKS = {torch.bfloat16: 850.0, torch.float32: 1200.0}
KTILE_MULTICAST_CLOCKS = {torch.bfloat16: 1700.0, torch.float32: 2300.0}
HBM_BYTES = 1900.0
L2_BYTES = 5000.0
EPI_ROUND_CLOCKS = 2000.0
EPI_BYTES = 8.0
BARRIER_CLOCKS = 1000.0  # a cluster's, times its CTAs; a CTA's: 100
FILL_CLOCKS = 2500.0


def geometry(B: int, H: int, W: int, C: int, Cm: int, dtype: torch.dtype, cs: int, ns: int,
             ni: int, ty: int, tx: int, mb1: int, stages: int) -> dict:
    """A plan's shapes, as the C launcher's ``geometry`` computes them: the
    x box (bx x by pixels of bi images: the item's halo window kept inside
    the image), the halo grid (HY x HX an image, npos rows of Y), phase 1's
    rows M1 and the item's pixels M2, the items, the output channels a CTA
    (nc, a multiple of a 128-byte row), a Y row's bytes, a ring slot's bytes,
    the CTA's biases' bytes and the shared memory."""
    es = 4 if dtype == torch.float32 else 2
    whole = ty == H and tx == W
    g = dict(bx=min(tx + 2, W), by=min(ty + 2, H), bi=ni if whole else 1, HY=ty + 2, HX=tx + 2)
    g["npos"] = ni * g["HY"] * g["HX"]
    g["M1"] = g["bi"] * g["by"] * g["bx"]
    g["M2"] = ni * ty * tx
    g["tiles_x"] = -(-W // tx)
    g["tiles"] = -(-H // ty) * g["tiles_x"]
    g["items"] = -(-B // ni) * g["tiles"]
    kt = 128 // es  # a 128-byte row's elements: no two CTAs' output boxes meet
    g["nc"] = -(-(-(-C // cs)) // kt) * kt
    g["yrow"] = cs * ns * es + 16
    g["slot"] = mb1 * 64 * 128 + ns * 128 * (2 if dtype == torch.float32 else 1)
    g["bias"] = (2 + -(-g["nc"] // ns)) * ns * 4  # float32 b1, b2 of the slice, b3 of the tiles
    g["smem"] = HEAD_BYTES + stages * g["slot"] + g["npos"] * g["yrow"] + g["bias"]
    return g


def plan_cost(B: int, H: int, W: int, C: int, Cm: int, dtype: torch.dtype, cs: int, ns: int,
              ni: int, ty: int, tx: int, mb1: int, mb2: int, stages: int, sms: int,
              active: Mapping[int, int]) -> float:
    """Estimated clocks of a launch: the waves of clusters the card runs (at
    ``active[cs]`` clusters at once) times a CTA's time, the sum over its
    k-tiles of the longest of their products, the least a k-tile takes and
    their bytes at the CTA's share of device memory (x) and of L2 (the
    weights), and of its output tiles' epilogues, barriers and first fill."""
    f32 = dtype == torch.float32
    es, kt, parts = (4, 32, 2) if f32 else (2, 64, 1)
    g = geometry(B, H, W, C, Cm, dtype, cs, ns, ni, ty, tx, mb1, stages)
    nk1, nkc = -(-C // kt), -(-Cm // kt)
    nt3 = -(-g["nc"] // ns)
    running = min(g["items"] * cs, active[cs] * cs, sms)  # CTAs at once
    hbm, l2 = HBM_BYTES / running, L2_BYTES / running
    wbytes = ns * 128 * parts
    rate, floor = MMA_RATE[dtype], KTILE_CLOCKS[dtype]

    def ktile(mb: int, x_bytes: float, least: float) -> float:
        flops = 2 * (3 if f32 else 1) * 64 * mb * kt * ns
        return max(flops / rate, least, x_bytes / hbm + wbytes / l2)

    phase1 = nk1 * ktile(mb1, g["M1"] * 128 / cs,
                         KTILE_MULTICAST_CLOCKS[dtype] if cs > 1 else floor)
    phase2 = 9 * nkc * ktile(mb2, 0, floor)
    rounds = -(-(ns * es // 128) // stages)
    tile_bytes = g["M2"] * ns * es
    phase3 = nt3 * (nkc * ktile(mb2, 0, floor) + rounds * EPI_ROUND_CLOCKS
                    + max(2 * tile_bytes / hbm, tile_bytes / EPI_BYTES))
    stores = (g["M1"] + g["M2"]) * ns * es * cs / 64
    barriers = 3 * (BARRIER_CLOCKS * cs if cs > 1 else 100.0)
    cta = phase1 + phase2 + phase3 + stores + barriers + FILL_CLOCKS
    return -(-g["items"] // active[cs]) * cta


@functools.lru_cache(maxsize=256)
def _candidates(B: int, H: int, W: int, C: int, Cm: int, dtype: torch.dtype, sms: int,
                active: tuple) -> tuple:
    counts = dict(active)
    found = []
    for ns in SLICES:
        cs = -(-Cm // ns)
        if cs > MAX_CLUSTER or counts.get(cs, 0) < 1:
            continue
        items = [(ni, H, W) for ni in range(1, min(MAX_IMAGES, B) + 1)]
        items += [(1, ty, tx) for ty in TILE_SIDES for tx in TILE_SIDES
                  if ty <= H and tx <= W and (ty, tx) != (H, W)]
        for ni, ty, tx in items:
            g = geometry(B, H, W, C, Cm, dtype, cs, ns, ni, ty, tx, 1, 2)
            need1, need2 = -(-g["M1"] // 64), -(-g["M2"] // 64)
            fits = sorted((m1, m2) for n, m1, m2 in INSTANCES[dtype]
                          if n == ns and m1 >= need1 and m2 >= need2)
            if not fits:
                continue
            mb1, mb2 = fits[0]
            g = geometry(B, H, W, C, Cm, dtype, cs, ns, ni, ty, tx, mb1, 0)
            stages = min(MAX_STAGES, (SMEM_LIMIT - g["smem"]) // g["slot"])
            if stages < 2 or max(g["bx"], g["by"], g["bi"], tx, ty) > 256:
                continue
            cost = plan_cost(B, H, W, C, Cm, dtype, cs, ns, ni, ty, tx, mb1, mb2, stages, sms,
                             counts)
            g = geometry(B, H, W, C, Cm, dtype, cs, ns, ni, ty, tx, mb1, stages)
            found.append(dict(cluster=cs, slice=ns, images=ni, tile_h=ty, tile_w=tx,
                              stages=stages, mb1=mb1, mb2=mb2, smem_bytes=g["smem"],
                              ctas=g["items"] * cs, clusters=g["items"],
                              active_clusters=counts[cs], waves=-(-g["items"] // counts[cs]),
                              cost_clocks=cost))
    if not found:
        raise ValueError(f"fused_bottleneck: no work item fits the card for x ({B}, {H}, {W}, "
                         f"{C}), Cm = {Cm}, {dtype}")
    return tuple(sorted(found, key=lambda p: p["cost_clocks"]))


def plan_candidates(B: int, H: int, W: int, C: int, Cm: int, dtype: torch.dtype, sms: int,
                    active: Mapping[int, int]) -> list:
    """Every work item ``kernel_plan`` weighs, least ``plan_cost`` first."""
    if C % CHANNEL_ALIGN or Cm % CHANNEL_ALIGN:
        raise ValueError(f"kernel_plan takes C and Cm multiples of {CHANNEL_ALIGN}, got {C}, {Cm}")
    return [dict(p) for p in _candidates(B, H, W, C, Cm, dtype, sms,
                                         tuple(sorted(active.items())))]


def kernel_plan(B: int, H: int, W: int, C: int, Cm: int, dtype: torch.dtype, sms: int,
                active: Mapping[int, int]) -> dict:
    """The kernel's work item for x (B, H, W, C) and Cm channels (both
    multiples of CHANNEL_ALIGN), on a card of ``sms`` SMs that runs
    ``active[cs]`` clusters of cs CTAs at once (one CTA an SM): for each
    slice of SLICES (cluster size ceil(Cm / slice)), whole images (1 to
    MAX_IMAGES an item) or a tile of TILE_SIDES with its halo, the row
    blocks of the smallest instance that holds it and the deepest ring that
    fits SMEM_LIMIT, the one with the least ``plan_cost``. Returns cluster,
    slice, images, tile_h, tile_w, stages, mb1, mb2 (what the C entry
    takes, in that order), smem_bytes, ctas, clusters, active_clusters,
    waves and cost_clocks."""
    if C % CHANNEL_ALIGN or Cm % CHANNEL_ALIGN:
        raise ValueError(f"kernel_plan takes C and Cm multiples of {CHANNEL_ALIGN}, got {C}, {Cm}")
    # Once a launch: copy the chosen plan only.
    return dict(_candidates(B, H, W, C, Cm, dtype, sms, tuple(sorted(active.items())))[0])


PLAN_KEYS = ("cluster", "slice", "images", "tile_h", "tile_w", "stages", "mb1", "mb2")


@functools.lru_cache(maxsize=16)
def active_clusters(device_index: int, dtype: torch.dtype) -> Dict[int, int]:
    """cudaOccupancyMaxActiveClusters of the kernel on that card for every
    cluster size up to MAX_CLUSTER, at one CTA an SM."""
    lib = _kernel_lib()
    out = {}
    with torch.cuda.device(device_index):
        for cs in range(1, MAX_CLUSTER + 1):
            n = ctypes.c_int(0)
            rc = lib.vct_fused_bottleneck_active_clusters(int(dtype == torch.float32), cs,
                                                          ctypes.byref(n))
            check_launch(lib, rc, "fused_bottleneck active clusters")
            out[cs] = n.value
    return out


def card_plan(x: Tensor, Cm: int) -> dict:
    """``kernel_plan`` for x (B, H, W, C) on its card, C and Cm as the
    kernel takes them (padded to multiples of CHANNEL_ALIGN)."""
    B, H, W, C = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return kernel_plan(B, H, W, _align(C), _align(Cm), x.dtype, sms,
                       active_clusters(x.device.index, x.dtype))


def _align(n: int) -> int:
    return -(-n // CHANNEL_ALIGN) * CHANNEL_ALIGN


def _kernel_operands(x, w1, b1, w2, b2, w3, b3) -> tuple:
    """The operands as the kernel takes them: C and Cm padded with zeros to
    multiples of CHANNEL_ALIGN (zero channels add nothing, and their
    outputs are dropped), every array 16-byte aligned."""
    C, Cm = x.shape[3], w1.shape[0]
    dc, dm = _align(C) - C, _align(Cm) - Cm
    if dc or dm:
        x = F.pad(x, (0, dc))
        w1, b1 = F.pad(w1, (0, dc, 0, dm)), F.pad(b1, (0, dm))
        w2 = F.pad(w2, (0, 0, 0, 0, 0, dm, 0, dm)).contiguous(memory_format=torch.channels_last)
        b2 = F.pad(b2, (0, dm))
        w3, b3 = F.pad(w3, (0, dm, 0, dc)), F.pad(b3, (0, dc))
    ops = [x, w1, b1, w2, b2, w3, b3]
    fmt = [torch.channels_last if i == 3 else torch.contiguous_format for i in range(7)]
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone(memory_format=f)
                 for t, f in zip(ops, fmt))


def fused_bottleneck(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, w3: Tensor,
                     b3: Tensor) -> Tensor:
    """One identity bottleneck block. CUDA: the kernel, on the current
    stream, no sync. CPU: the plain version."""
    if tracing():
        return torch.ops.vct.fused_bottleneck(x, w1, b1, w2, b2, w3, b3)
    _check(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cpu or cuda, got {x.device}")
    if w1.shape[0] > MAX_CM:
        raise ValueError(f"fused_bottleneck on the card takes Cm <= {MAX_CM}, got {w1.shape[0]}")
    lib = _kernel_lib()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    B, H, W, C = x.shape
    ops = _kernel_operands(x, w1, b1, w2, b2, w3, b3)
    Cp, Cmp = ops[0].shape[3], ops[1].shape[0]
    with torch.cuda.device(x.device):
        plan = card_plan(x, w1.shape[0])
        args = (ctypes.c_int * len(PLAN_KEYS))(*(plan[k] for k in PLAN_KEYS))
        scratch = None
        if x.dtype == torch.float32:  # w's TF32 hi and lo parts
            up4 = lambda n: -(-n // 4) * 4  # noqa: E731
            scratch = torch.empty(2 * (2 * up4(Cmp * Cp) + up4(9 * Cmp * Cmp)),
                                  dtype=torch.float32, device=x.device)
        dst = out if Cp == C else torch.empty((B, H, W, Cp), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"vct_fused_bottleneck_{_DTYPES[x.dtype]}")(
            *(t.data_ptr() for t in ops[:7]), dst.data_ptr(), B, H, W, Cp, Cmp, args,
            None if scratch is None else scratch.data_ptr(), stream)
    check_launch(lib, rc, "fused_bottleneck")
    if dst is not out:
        out.copy_(dst[..., :C])
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
