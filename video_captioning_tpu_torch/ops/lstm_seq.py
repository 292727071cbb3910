"""Whole-sequence masked LSTM recurrence: the encoder's eval-time scan.

Counterpart of video_captioning_tpu/ops/lstm_seq_pallas.py
(lstm_seq_pallas), with the same layout at the public function: xproj
(T, ND, B, 4H) input projections plus biases, w_hh (ND, H, 4H), mask (B, T)
or None. On a CUDA tensor ``lstm_seq`` launches the persistent kernel in
``csrc/lstm_seq.cu``; on a CPU tensor it runs ``lstm_seq_reference``, the
plain PyTorch version of the same numeric contract: bf16 h and W_hh in
the recurrent product with float32 sums, float32 gates and state, padded
steps carry the state and emit 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import check_launch, load_library

Tensor = torch.Tensor


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
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.vct_lstm_seq_max_hidden.argtypes = []
    lib.vct_lstm_seq_max_hidden.restype = ctypes.c_int
    return lib


def lstm_seq(
    xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Full recurrence over T steps. ``w_hh`` must already be bfloat16
    (callers cast it once per model load). CUDA: the kernel, on the current
    stream, no sync. CPU: the plain version."""
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
    h_state = torch.zeros((ND, B, H), dtype=torch.float32, device=dev)
    c_state = torch.zeros_like(h_state)
    hbuf = torch.zeros((2, ND, B, H), dtype=torch.bfloat16, device=dev)
    mask_f = None if mask is None else mask.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vct_lstm_seq(
            xproj.data_ptr(), int(xproj.dtype == torch.bfloat16),
            w_hh.data_ptr(), None if mask_f is None else mask_f.data_ptr(),
            outs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            h_state.data_ptr(), c_state.data_ptr(), hbuf.data_ptr(),
            T, ND, B, H, stream,
        )
    check_launch(lib, rc, "lstm_seq")
    lstm_seq.launches += 1
    return outs, (h_last, c_last)


lstm_seq.launches = 0
