"""Differentiable whole-sequence masked LSTM: the encoder's training scan.

Counterpart of video_captioning_tpu/ops/lstm_seq_pallas.py
(lstm_seq_train, a ``jax.custom_vjp``), with the same layout at the public
function: xproj (T, ND, B, 4H) input projections plus biases, w_hh
(ND, H, 4H), mask (B, T) or None. ``lstm_seq_train`` is a
``torch.autograd.Function`` whose forward runs ``lstm_seq_train_fwd`` and
whose backward runs ``lstm_seq_train_bwd``. On CUDA tensors each of them
launches its kernel in ``csrc/lstm_seq_train.cu``; on CPU tensors each runs
its plain PyTorch version below, which follows the kernel bodies step by
step. The numeric contract is the file header of ``csrc/lstm_seq_train.cu``:
bf16 operands with float32 sums in both recurrent products and in dW_hh,
float32 gates, state and residuals, dxproj the float32 dgates cast to
xproj's type. Both kernels take H a multiple of 8 up to 1024 (the forward
one tile for every H, the backward sweep a narrow form up to 600 and a wide
form above); ``wide_launches`` on each wrapper counts its launches past
H = 600 among its ``launches``. ``bwd_wide_plan`` mirrors the wide
backward sweep's launch plan, which the C launcher picks (its rows, ring of
dgates stages and shared memory), for the CPU tests; ``dw_plan`` is the
dW_hh launch's plan (its stages and the cluster's parts), which the wrapper
passes to the C entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .build import check_launch, load_library
from .lstm_seq import (CARD_SMS, NARROW_MAX_HIDDEN, SMEM_LIMIT, WIDE_MIN_ROWS, WIDE_UNITS,
                       check_inputs, fwd_ring)

Tensor = torch.Tensor

# The wide backward sweep's plan as the C launcher picks it (csrc/
# lstm_seq_train.cu: lstm_seq_bwd_wide_kernel, bwd_wide_smem_bytes,
# bwd_wide_ring; launch_recurrence's row groups and slices).
BWD_WIDE_THREADS = 512  # 16 warps, all along K
BWD_WIDE_WARPS = BWD_WIDE_THREADS // 32
BWD_CLUSTER = 2         # CTAs a cluster: neighbouring unit groups that split K
BWD_ROWS = 16           # batch rows a staged dgates chunk
BWD_COL_TILES = 64      # k-tiles of 16 a staged column chunk (1024 columns)
BWD_WIDE_GSTRIDE = BWD_COL_TILES * 16 + 8  # bf16 a staged row
BWD_WIDE_PART = BWD_CLUSTER * WIDE_UNITS + 8  # floats a row of a warp's partial sums
BWD_MAX_RING = 8


def bwd_wide_smem(nb: int, ring: int) -> int:
    """Shared memory of a wide backward CTA (bwd_wide_smem_bytes): the
    ring's and the staged inputs' mbarriers, ``ring`` slots of BWD_ROWS x
    1024 bf16 dgates, 16 warps' partial sums of the cluster's 32 units, DH
    and DC of nb rows, the step's mask, the two ranks' parts of DH, and the
    next step's inputs in float32 room (gact 4 x 16, c_keep at t and t - 1,
    douts, the mask)."""
    return (-(-8 * (ring + 1) // 16) * 16 + ring * BWD_ROWS * BWD_WIDE_GSTRIDE * 2
            + BWD_WIDE_WARPS * BWD_ROWS * BWD_WIDE_PART * 4
            + nb * WIDE_UNITS * 8 + -(-nb // 4) * 16 + BWD_CLUSTER * nb * WIDE_UNITS * 4
            + nb * 7 * WIDE_UNITS * 4 + nb * 4)


def bwd_wide_col_chunks(H: int) -> int:
    """Column chunks of BWD_COL_TILES k-tiles in a CTA's half of 4H."""
    return -(-(4 * H // BWD_CLUSTER // 16) // BWD_COL_TILES)


def bwd_wide_ring(nb: int, H: int) -> int:
    """The ring's slots for CTAs of nb rows (bwd_wide_ring): the most that
    fit, at most a step's stages and BWD_MAX_RING; 1 when none fits."""
    ring = min(-(-nb // BWD_ROWS) * bwd_wide_col_chunks(H), BWD_MAX_RING)
    while ring > 1 and bwd_wide_smem(nb, ring) > SMEM_LIMIT:
        ring -= 1
    return ring


@functools.lru_cache(maxsize=4096)
def bwd_wide_plan(H: int, B: int, ND: int = 2, sms: int = CARD_SMS) -> dict:
    """The wide backward sweep's launch plan at 600 < H <= 1024:
    ``unit_groups`` CTAs of WIDE_UNITS units (BWD_WIDE_THREADS threads) a
    direction and row group, padded to a multiple of BWD_CLUSTER (clusters
    of neighbouring unit groups that split K: each CTA multiplies half of
    the 4H dgates columns by W_hh of the pair's units; a padding CTA's
    units all lie past H), one CTA an SM (W_hh in registers), so
    ND x row_groups x unit_groups <= sms; the most row groups of at least
    WIDE_MIN_ROWS rows that fit (``nb`` rows a CTA), or one row group over
    sequential ``slice``-row launches where even one does not fit shared
    memory. A step reads its half of the direction's dgates in ``stages``
    of BWD_ROWS rows x 1024 columns (``chunks`` row chunks x
    ``col_chunks``); ``ring`` of them are in flight (``bwd_wide_ring``:
    all 4 at B = 32, H = 1024)."""
    ug = -(-H // WIDE_UNITS)
    ug = -(-ug // BWD_CLUSTER) * BWD_CLUSTER
    col_chunks = bwd_wide_col_chunks(H)

    def smem(nb: int) -> int:
        return bwd_wide_smem(nb, bwd_wide_ring(nb, H))

    groups, nb = 0, 0
    for g in range(max(1, B // WIDE_MIN_ROWS), 0, -1):
        nb = -(-B // g)
        if ND * g * ug <= sms and smem(nb) <= SMEM_LIMIT:
            groups = g
            break
    slice_rows = B
    if not groups:  # one row group; the rows in sequential slices
        groups = 1
        while smem(slice_rows) > SMEM_LIMIT:
            if slice_rows <= WIDE_MIN_ROWS:
                raise ValueError(f"no wide backward plan fits H = {H}, B = {B}")
            slice_rows = -(-slice_rows // 2)
        nb = slice_rows
    ring = bwd_wide_ring(nb, H)
    chunks = -(-nb // BWD_ROWS)
    return dict(unit_groups=ug, row_groups=groups, nb=nb, slice=slice_rows,
                launches=-(-B // slice_rows), chunks=chunks, col_chunks=col_chunks,
                stages=chunks * col_chunks, ring=ring, smem=bwd_wide_smem(nb, ring),
                ctas=ND * groups * ug)


# The dW_hh launch (csrc/lstm_seq_train.cu: lstm_seq_dw_kernel, its kDw*
# constants and kDwSmem), which takes its plan from ``dw_plan``.
DW_M, DW_N, DW_K = 128, 256, 64  # a CTA's tile of (H, 4H) and a stage's rows at most
DW_RING = 3                      # stages in flight
DW_MAX_PARTS = 8                 # CTAs of a cluster that split the stages (kDwMaxParts)
DW_MIN_STEPS = 4                 # stages a part takes at least
# Stages of 8 boxes of DW_K rows x 128 bytes (4 of bf16 dgates, 4 of
# float32 h); the parts' exchange (rows of DW_N + 8 floats) aliases them;
# a ring's mbarriers and 1024 bytes of alignment.
DW_SMEM = max(DW_RING * 8 * DW_K * 128, DW_M * (DW_N + 8) * 4) + 8 * DW_RING + 1024


def dw_plan(T: int, B: int, H: int, ND: int = 2, sms: int = CARD_SMS) -> dict:
    """The dW_hh launch's plan: ``tiles`` CTA tiles of DW_M x DW_N of each
    direction's (H, 4H) product; the reduction's rows
    (t - 1, b) for t >= 1 in ``steps`` stages of ``tbox`` steps x ``bbox``
    rows (all B rows of DW_K // B steps when B < DW_K, else DW_K rows of one
    step, ``nbc`` boxes a step), split over ``parts`` CTAs of a thread block
    cluster (a power of two up to DW_MAX_PARTS: the most whose ``ctas`` fit
    ``sms`` at one CTA an SM, each part at least DW_MIN_STEPS stages),
    ``part_steps`` stages a part; each rank adds the parts of its ``own``
    rows of the tile in rank order."""
    bbox, tbox = (B, DW_K // B) if B < DW_K else (DW_K, 1)
    nbc = -(-B // bbox)
    tiles = -(-4 * H // DW_N) * -(-H // DW_M) * ND
    steps = -(-(T - 1) // tbox) * nbc
    parts = 1
    while parts < DW_MAX_PARTS and tiles * parts * 2 <= sms and steps >= parts * 2 * DW_MIN_STEPS:
        parts *= 2
    return dict(tiles=tiles, bbox=bbox, tbox=tbox, nbc=nbc, steps=steps, parts=parts,
                part_steps=-(-steps // parts), ctas=tiles * parts, own=DW_M // parts,
                smem=DW_SMEM)


def _bf16_exact(x: Tensor) -> Tensor:
    """x rounded to bf16 and held in float32: exact products, float32 sums."""
    return x.to(torch.bfloat16).float()


def lstm_seq_train_fwd_reference(
    xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain forward. Returns outs (T, ND, B, H), h_last, c_last (ND, B, H)
    in xproj's type, and the residuals gact (T, ND, B, 4H) in xproj's type,
    h_keep and c_keep (T, ND, B, H) float32."""
    T, ND, B, H4 = xproj.shape
    dt = xproj.dtype
    w = _bf16_exact(w_hh)
    h = torch.zeros((ND, B, H4 // 4), dtype=torch.float32, device=xproj.device)
    c = torch.zeros_like(h)
    valid = None if mask is None else (mask > 0)
    outs, gacts, h_keep, c_keep = [], [], [], []
    for t in range(T):
        gates = xproj[t].float() + torch.bmm(_bf16_exact(h), w)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if valid is None:
            h, c, out = h_new, c_new, h_new
        else:
            m = valid[:, t][None, :, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            out = torch.where(m, h_new, torch.zeros_like(h_new))
        outs.append(out.to(dt))
        gacts.append(torch.cat([i, f, g, o], dim=-1).to(dt))
        h_keep.append(h)
        c_keep.append(c)
    return (torch.stack(outs), h.to(dt), c.to(dt),
            torch.stack(gacts), torch.stack(h_keep), torch.stack(c_keep))


def lstm_seq_train_bwd_reference(
    gact: Tensor, h_keep: Tensor, c_keep: Tensor, w_hh: Tensor,
    mask: Optional[Tensor], douts: Optional[Tensor],
    dh_last: Optional[Tensor] = None, dc_last: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain backward: the reverse-time sweep. Returns dxproj
    (T, ND, B, 4H) in gact's type and dW_hh (ND, H, 4H) float32. A ``None``
    cotangent means zeros."""
    T, ND, B, H4 = gact.shape
    dev = gact.device
    w_t = _bf16_exact(w_hh).transpose(1, 2)  # (ND, 4H, H)
    m_all = (torch.ones((B, T), device=dev) if mask is None else mask.float())
    zeros = torch.zeros((ND, B, H4 // 4), dtype=torch.float32, device=dev)
    DH = zeros if dh_last is None else dh_last.float()
    DC = zeros if dc_last is None else dc_last.float()
    dw = torch.zeros((ND, H4 // 4, H4), dtype=torch.float32, device=dev)
    dxproj = torch.empty_like(gact)
    for t in reversed(range(T)):
        i, f, g, o = gact[t].float().chunk(4, dim=-1)
        c_new = c_keep[t]
        c_prev = c_keep[t - 1] if t > 0 else zeros
        h_prev = h_keep[t - 1] if t > 0 else zeros
        m = m_all[:, t][None, :, None]
        dout = zeros if douts is None else douts[t].float()
        dh_new = m * (dout + DH)
        tanh_c = torch.tanh(c_new)
        do_ = dh_new * tanh_c
        dc_new = m * DC + dh_new * o * (1.0 - tanh_c * tanh_c)
        di, dg, df = dc_new * g, dc_new * i, dc_new * c_prev
        dc_prev = dc_new * f + (1.0 - m) * DC
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do_ * o * (1.0 - o)], dim=-1)
        dgates_b = _bf16_exact(dgates)
        dh_prev = torch.bmm(dgates_b, w_t) + (1.0 - m) * DH
        dw += torch.bmm(_bf16_exact(h_prev).transpose(1, 2), dgates_b)
        dxproj[t] = dgates.to(gact.dtype)
        DH, DC = dh_prev, dc_prev
    return dxproj, dw


def _kernel_lib() -> ctypes.CDLL:
    return _typed(load_library("lstm_seq_train"))


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/lstm_seq_train.cu) with its entries' types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vct_lstm_seq_train_fwd.argtypes = [p, i] + [p] * 10 + [i] * 5 + [p]
    lib.vct_lstm_seq_train_fwd.restype = i
    lib.vct_lstm_seq_train_bwd.argtypes = [p, i] + [p] * 11 + [i] * 7 + [p]
    lib.vct_lstm_seq_train_bwd.restype = i
    for limit in (lib.vct_lstm_seq_train_max_hidden, lib.vct_lstm_seq_train_narrow_max_hidden):
        limit.argtypes = []
        limit.restype = i
    return lib


def _cuda_lib(xproj: Tensor, what: str) -> ctypes.CDLL:
    if xproj.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {xproj.device}")
    lib = _kernel_lib()
    H = xproj.shape[-1] // 4
    top = lib.vct_lstm_seq_train_max_hidden()
    if H % 8 or H > top:
        raise ValueError(f"{what} kernel takes H a multiple of 8 up to {top}, got {H}")
    return lib


@functools.lru_cache(maxsize=None)
def _card_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _mask_f32(mask: Optional[Tensor]) -> Optional[Tensor]:
    return None if mask is None else mask.to(torch.float32).contiguous()


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def lstm_seq_train_fwd(
    xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Forward with residuals; ``w_hh`` must already be bfloat16. CUDA: the
    kernel, on the current stream, no sync. CPU: the plain version."""
    check_inputs(xproj, w_hh, mask, "lstm_seq_train_fwd")
    if xproj.device.type == "cpu":
        return lstm_seq_train_fwd_reference(xproj, w_hh, mask)
    lib = _cuda_lib(xproj, "lstm_seq_train_fwd")
    T, ND, B, H4 = xproj.shape
    H = H4 // 4
    dev, dt = xproj.device, xproj.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((T, ND, B, H), dtype=dt, device=dev)
    h_last = torch.empty((ND, B, H), dtype=dt, device=dev)
    c_last = torch.empty_like(h_last)
    gact = torch.empty((T, ND, B, H4), dtype=dt, device=dev)
    h_keep = torch.empty((T, ND, B, H), **f32)
    c_keep = torch.empty((T, ND, B, H), **f32)
    # Scratch the kernel initialises itself: the h exchange and the
    # counters of the CTAs that share rows (zeroed on the stream before
    # each launch; at most one per row and direction).
    hbuf = torch.empty((2, ND, B, H), dtype=torch.bfloat16, device=dev)
    sync = torch.empty((ND, B), dtype=torch.int32, device=dev)
    mask_f = _mask_f32(mask)
    with torch.cuda.device(dev):
        rc = lib.vct_lstm_seq_train_fwd(
            xproj.data_ptr(), int(dt == torch.bfloat16), w_hh.data_ptr(), _ptr(mask_f),
            outs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            hbuf.data_ptr(), sync.data_ptr(), gact.data_ptr(), h_keep.data_ptr(),
            c_keep.data_ptr(),
            T, ND, B, H, fwd_ring(H, B, ND), torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "lstm_seq_train_fwd")
    lstm_seq_train_fwd.launches += 1
    if H > NARROW_MAX_HIDDEN:
        lstm_seq_train_fwd.wide_launches += 1
    return outs, h_last, c_last, gact, h_keep, c_keep


lstm_seq_train_fwd.launches = 0
lstm_seq_train_fwd.wide_launches = 0  # of them, those past H = 600 (the wide encoder's)


def lstm_seq_train_bwd(
    gact: Tensor, h_keep: Tensor, c_keep: Tensor, w_hh: Tensor,
    mask: Optional[Tensor], douts: Optional[Tensor],
    dh_last: Optional[Tensor] = None, dc_last: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Backward: dxproj in gact's type and dW_hh float32. CUDA: the sweep
    and the dW_hh kernels, on the current stream, no sync. CPU: the plain
    version. A ``None`` cotangent means zeros."""
    check_inputs(gact, w_hh, mask, "lstm_seq_train_bwd")
    T, ND, B, H4 = gact.shape
    H = H4 // 4
    dev, dt = gact.device, gact.dtype
    for name, x, shape in (("h_keep", h_keep, (T, ND, B, H)), ("c_keep", c_keep, (T, ND, B, H)),
                           ("douts", douts, (T, ND, B, H)), ("dh_last", dh_last, (ND, B, H)),
                           ("dc_last", dc_last, (ND, B, H))):
        if x is not None and (tuple(x.shape) != shape or x.device != dev):
            raise ValueError(f"lstm_seq_train_bwd takes {name} {shape} on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
    if dev.type == "cpu":
        return lstm_seq_train_bwd_reference(gact, h_keep, c_keep, w_hh, mask, douts,
                                            dh_last, dc_last)
    lib = _cuda_lib(gact, "lstm_seq_train_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    if h_keep.dtype != torch.float32 or c_keep.dtype != torch.float32:
        raise ValueError("lstm_seq_train_bwd takes float32 h_keep and c_keep")
    h_keep, c_keep = h_keep.contiguous(), c_keep.contiguous()
    # A missing cotangent goes to the kernel as a null pointer (zeros).
    douts = None if douts is None else douts.to(dt).contiguous()
    # The dW_hh launch stages h_keep by 16-byte copies, and the wide sweep
    # gact, c_keep and douts.
    staged = (h_keep, gact, c_keep, douts) if H > NARROW_MAX_HIDDEN else (h_keep,)
    h_keep, *rest = (x if x is None or x.data_ptr() % 16 == 0 else x.clone() for x in staged)
    if rest:
        gact, c_keep, douts = rest
    dh_last = None if dh_last is None else dh_last.to(torch.float32).contiguous()
    dc_last = None if dc_last is None else dc_last.to(torch.float32).contiguous()
    # The sweep's bf16 dgates, a slot a step: its exchange, then the dW_hh
    # launch's operand.
    gbuf = torch.empty((T, ND, B, H4), dtype=torch.bfloat16, device=dev)
    sync = torch.empty((ND, B), dtype=torch.int32, device=dev)
    dxproj = torch.empty((T, ND, B, H4), dtype=dt, device=dev)
    dw = torch.empty((ND, H, H4), **f32)
    mask_f = _mask_f32(mask)
    plan = dw_plan(T, B, H, ND, _card_sms(dev))
    with torch.cuda.device(dev):
        rc = lib.vct_lstm_seq_train_bwd(
            gact.data_ptr(), int(dt == torch.bfloat16), h_keep.data_ptr(), c_keep.data_ptr(),
            w_hh.data_ptr(), _ptr(mask_f), _ptr(douts), _ptr(dh_last), _ptr(dc_last),
            gbuf.data_ptr(), sync.data_ptr(), dxproj.data_ptr(), dw.data_ptr(), T, ND, B, H,
            plan["parts"], plan["bbox"], plan["tbox"], torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "lstm_seq_train_bwd")
    lstm_seq_train_bwd.launches += 1
    if H > lib.vct_lstm_seq_train_narrow_max_hidden():
        lstm_seq_train_bwd.wide_launches += 1
    return dxproj, dw


lstm_seq_train_bwd.launches = 0
lstm_seq_train_bwd.wide_launches = 0  # of them, the wide sweep's


class _LSTMSeqTrain(torch.autograd.Function):
    """Forward kernel saves gact, h_keep, c_keep, the bf16 W_hh and the
    mask; backward kernel returns (dxproj, dW_hh in w_hh's type, None)."""

    @staticmethod
    def forward(ctx, xproj, w_hh, mask):
        w_bf16 = w_hh.detach().to(torch.bfloat16).contiguous()
        outs, h_last, c_last, gact, h_keep, c_keep = lstm_seq_train_fwd(
            xproj.detach().contiguous(), w_bf16, mask)
        ctx.save_for_backward(gact, h_keep, c_keep, w_bf16, mask)
        ctx.w_dtype = w_hh.dtype
        return outs, h_last, c_last

    @staticmethod
    def backward(ctx, douts, dh_last, dc_last):
        gact, h_keep, c_keep, w_bf16, mask = ctx.saved_tensors
        dxproj, dw = lstm_seq_train_bwd(gact, h_keep, c_keep, w_bf16, mask,
                                        douts, dh_last, dc_last)
        return dxproj, dw.to(ctx.w_dtype), None


def lstm_seq_train(
    xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Differentiable full recurrence: (outs, (h_last, c_last)) as
    ``lstm_seq`` returns them. ``w_hh`` (ND, H, 4H) may be float32 and
    require grad; it is cast to bf16 inside."""
    outs, h_last, c_last = _LSTMSeqTrain.apply(xproj, w_hh, mask)
    return outs, (h_last, c_last)
