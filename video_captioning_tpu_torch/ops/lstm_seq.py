"""Whole-sequence masked LSTM recurrence: the encoder's eval-time scan.

Counterpart of video_captioning_tpu/ops/lstm_seq_pallas.py
(lstm_seq_pallas), with the same layout at the public function: xproj
(T, ND, B, 4H) input projections plus biases, w_hh (ND, H, 4H), mask (B, T)
or None. On a CUDA tensor ``lstm_seq`` launches the persistent kernel in
``csrc/lstm_seq.cu`` (bf16 tensor-core products); on a CPU tensor it runs
``lstm_seq_reference``, the plain PyTorch version of the same numeric
contract: bf16 h and W_hh in the recurrent product with float32 sums,
float32 gates and state, padded steps carry the state and emit 0. The
kernel takes H a multiple of 8 up to 1024, one tile for every H;
``lstm_seq.wide_launches`` counts its launches past H = 600 (the wide
encoder's) among ``lstm_seq.launches``. ``fwd_wide_plan`` is the
forward's launch plan (shared with ``lstm_seq_train``'s forward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor

# The forward's plan (csrc/lstm_seq_fwd.cuh: Fwd, kMaxRing, fwd_smem_bytes;
# launch_recurrence's row groups and slices).
NARROW_MAX_HIDDEN = 600  # kMaxHidden: the narrow backward sweep's largest H
WIDE_UNITS = 16          # hidden units a CTA
WIDE_ROWS = 32           # batch rows a chunk of h
WIDE_THREADS = 512       # one epilogue item a thread: WIDE_UNITS x WIDE_ROWS
WIDE_KW = 8              # warps along K, whose partial sums meet in shared memory
WIDE_PART_STRIDE = 4 * WIDE_UNITS + 8  # floats a row of a warp's partial sums
WIDE_MAX_RING = 16       # kMaxRing
WIDE_MIN_ROWS = 16       # launch_recurrence's min_rows
SMEM_LIMIT = 232448      # bytes a CTA may hold on Hopper (227 KB)
CARD_SMS = 132           # an H100 SXM's SMs


def fwd_wide_smem(H: int, nb: int, ring: int) -> int:
    """Shared memory of a forward CTA (fwd_smem_bytes): the ring's
    mbarriers, ``ring`` slots of WIDE_ROWS bf16 h rows (stride kpad + 8),
    the WIDE_KW warps' partial sums and the float32 h and c of nb rows."""
    kpad = -(-H // 16) * 16
    return (-(-8 * ring // 16) * 16 + ring * WIDE_ROWS * (kpad + 8) * 2
            + WIDE_KW * WIDE_ROWS * WIDE_PART_STRIDE * 4 + nb * WIDE_UNITS * 8)


@functools.lru_cache(maxsize=1024)
def fwd_wide_plan(H: int, B: int, ND: int = 2, sms: int = CARD_SMS) -> dict:
    """The forward's launch plan at every H up to 1024: ``unit_groups``
    CTAs of WIDE_UNITS units (WIDE_THREADS threads) a direction and row
    group, one CTA an SM (W_hh in registers), so ND x row_groups x
    unit_groups <= sms; the most row groups of at least WIDE_MIN_ROWS rows
    that fit (``nb`` rows a CTA), or one row group over sequential
    ``slice``-row launches where even one does not fit shared memory;
    ``ring`` chunk slots of h (the most that fit beside the partial sums
    and the carried state, at most the ``chunks`` a step and WIDE_MAX_RING;
    two at B = 128, H = 1024), every slot's copies issued as soon as h is
    published or the slot is free."""
    ug = -(-H // WIDE_UNITS)

    def ring_for(nb: int) -> int:
        ring = min(-(-nb // WIDE_ROWS), WIDE_MAX_RING)
        while ring > 1 and fwd_wide_smem(H, nb, ring) > SMEM_LIMIT:
            ring -= 1
        return ring if fwd_wide_smem(H, nb, ring) <= SMEM_LIMIT else 0

    groups, nb, ring = 0, 0, 0
    for g in range(max(1, B // WIDE_MIN_ROWS), 0, -1):
        nb = -(-B // g)
        if ND * g * ug <= sms and ring_for(nb):
            groups, ring = g, ring_for(nb)
            break
    slice_rows = B
    if not groups:  # one row group; the rows in sequential slices
        groups = 1
        while fwd_wide_smem(H, slice_rows, 1) > SMEM_LIMIT:
            if slice_rows <= WIDE_MIN_ROWS:
                raise ValueError(f"no wide forward plan fits H = {H}, B = {B}")
            slice_rows = -(-slice_rows // 2)
        nb, ring = slice_rows, ring_for(slice_rows)
    return dict(unit_groups=ug, row_groups=groups, nb=nb, slice=slice_rows,
                launches=-(-B // slice_rows), chunks=-(-nb // WIDE_ROWS), ring=ring,
                smem=fwd_wide_smem(H, nb, ring), ctas=ND * groups * ug)


def fwd_ring(H: int, B: int, ND: int) -> int:
    """The ``ring`` argument of the forward launches: the plan's."""
    return fwd_wide_plan(H, B, ND)["ring"]


def lstm_seq_reference(
    xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Plain version. Returns outputs (T, ND, B, H) and (h_last, c_last)
    (ND, B, H), all in xproj's dtype."""
    T, ND, B, H4 = xproj.shape
    H = H4 // 4
    dt = xproj.dtype
    w = w_hh.to(torch.bfloat16).float()  # exact bf16 values, float32 sums
    h = torch.zeros((ND, B, H), dtype=torch.float32, device=xproj.device)
    c = torch.zeros_like(h)
    valid = None if mask is None else (mask > 0)
    outs = []
    for t in range(T):
        gates = xproj[t].float() + torch.bmm(h.to(torch.bfloat16).float(), w)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if valid is None:
            h, c, out = h_new, c_new, h_new
        else:
            m = valid[:, t][None, :, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            out = torch.where(m, h_new, torch.zeros_like(h_new))
        outs.append(out.to(dt))
    return torch.stack(outs), (h.to(dt), c.to(dt))


def check_inputs(xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor],
                 what: str = "lstm_seq") -> None:
    """Raise on what the recurrence kernels do not take."""
    if xproj.ndim != 4 or xproj.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"{what} takes xproj (T, ND, B, 4H) float32 or bfloat16, got "
            f"{xproj.dtype} {tuple(xproj.shape)}"
        )
    T, ND, B, H4 = xproj.shape
    if H4 % 4 or T == 0 or B == 0:
        raise ValueError(f"{what}: bad xproj shape {tuple(xproj.shape)}")
    if w_hh.dtype != torch.bfloat16 or tuple(w_hh.shape) != (ND, H4 // 4, H4):
        raise ValueError(
            f"{what} takes w_hh (ND, H, 4H) = {(ND, H4 // 4, H4)} bfloat16, "
            f"got {w_hh.dtype} {tuple(w_hh.shape)}"
        )
    if mask is not None and tuple(mask.shape) != (B, T):
        raise ValueError(f"{what} takes mask (B, T) = {(B, T)}, got {tuple(mask.shape)}")
    for name, t in (("xproj", xproj), ("w_hh", w_hh), ("mask", mask)):
        if t is not None and t.device != xproj.device:
            raise ValueError(f"{what}: {name} is on {t.device}, xproj on {xproj.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} takes a contiguous {name}")


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("lstm_seq")
    fn = lib.vct_lstm_seq
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.vct_lstm_seq_max_hidden.argtypes = []
    lib.vct_lstm_seq_max_hidden.restype = ctypes.c_int
    return lib


def kernel_max_hidden(train: bool = False) -> int:
    """The largest H the recurrence kernels take (``kMaxWideHidden``,
    csrc/lstm_seq_fwd.cuh; the backward sweep's narrow form up to
    ``kMaxHidden``, its wide form above), read from the built library: ``lstm_seq``'s, or
    ``lstm_seq_train``'s with ``train``. Builds the library on first use."""
    if train:
        from .lstm_seq_train import _kernel_lib as train_lib

        return train_lib().vct_lstm_seq_train_max_hidden()
    return _kernel_lib().vct_lstm_seq_max_hidden()


def lstm_seq_eligible(H: int, dtype: torch.dtype, device: torch.device,
                      train: bool = False) -> bool:
    """The domain of the recurrence kernels (``lstm_seq``, or ``lstm_seq_train``
    with ``train``): float32 or bfloat16 xproj, and on CUDA H a multiple of 8
    up to the kernel's ``kernel_max_hidden``. The plain versions on the CPU
    take every H. Callers take another path outside this domain; the
    wrappers raise there."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if device.type == "cuda":
        return H % 8 == 0 and H <= kernel_max_hidden(train)
    return device.type == "cpu"


def lstm_seq(
    xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Full recurrence over T steps. ``w_hh`` must already be bfloat16
    (callers cast it once per model load). CUDA: the kernel, on the current
    stream, no sync. CPU: the plain version."""
    if tracing():
        outs, h, c = torch.ops.vct.lstm_seq(xproj, w_hh, mask)
        return outs, (h, c)
    check_inputs(xproj, w_hh, mask)
    if xproj.device.type == "cpu":
        return lstm_seq_reference(xproj, w_hh, mask)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_seq runs on cpu or cuda, got {xproj.device}")
    lib = _kernel_lib()
    T, ND, B, H4 = xproj.shape
    H = H4 // 4
    if H % 8 or H > lib.vct_lstm_seq_max_hidden():
        raise ValueError(
            f"lstm_seq kernel takes H a multiple of 8 up to "
            f"{lib.vct_lstm_seq_max_hidden()}, got {H}"
        )
    dev = xproj.device
    outs = torch.empty((T, ND, B, H), dtype=xproj.dtype, device=dev)
    h_last = torch.empty((ND, B, H), dtype=xproj.dtype, device=dev)
    c_last = torch.empty_like(h_last)
    # Scratch the kernel initialises itself: the h exchange and the
    # counters of the CTAs that share rows (zeroed on the stream before
    # each launch; at most one per row and direction).
    hbuf = torch.empty((2, ND, B, H), dtype=torch.bfloat16, device=dev)
    sync = torch.empty((ND, B), dtype=torch.int32, device=dev)
    mask_f = None if mask is None else mask.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vct_lstm_seq(
            xproj.data_ptr(), int(xproj.dtype == torch.bfloat16),
            w_hh.data_ptr(), None if mask_f is None else mask_f.data_ptr(),
            outs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            hbuf.data_ptr(), sync.data_ptr(), T, ND, B, H, fwd_ring(H, B, ND), stream,
        )
    check_launch(lib, rc, "lstm_seq")
    lstm_seq.launches += 1
    if H > NARROW_MAX_HIDDEN:
        lstm_seq.wide_launches += 1
    return outs, (h_last, c_last)


lstm_seq.launches = 0
lstm_seq.wide_launches = 0  # of them, those past H = 600 (the wide encoder's)
