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
xproj's type.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import check_launch, load_library
from .lstm_seq import check_inputs

Tensor = torch.Tensor


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
    lib = load_library("lstm_seq_train")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vct_lstm_seq_train_fwd.argtypes = [p, i] + [p] * 11 + [i] * 4 + [p]
    lib.vct_lstm_seq_train_fwd.restype = i
    lib.vct_lstm_seq_train_bwd.argtypes = [p, i] + [p] * 10 + [i] * 4 + [p]
    lib.vct_lstm_seq_train_bwd.restype = i
    lib.vct_lstm_seq_train_max_hidden.argtypes = []
    lib.vct_lstm_seq_train_max_hidden.restype = i
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
    h_state = torch.zeros((ND, B, H), **f32)
    c_state = torch.zeros((ND, B, H), **f32)
    hbuf = torch.zeros((2, ND, B, H), dtype=torch.bfloat16, device=dev)
    mask_f = _mask_f32(mask)
    with torch.cuda.device(dev):
        rc = lib.vct_lstm_seq_train_fwd(
            xproj.data_ptr(), int(dt == torch.bfloat16), w_hh.data_ptr(), _ptr(mask_f),
            outs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            h_state.data_ptr(), c_state.data_ptr(), hbuf.data_ptr(),
            gact.data_ptr(), h_keep.data_ptr(), c_keep.data_ptr(),
            T, ND, B, H, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "lstm_seq_train_fwd")
    lstm_seq_train_fwd.launches += 1
    return outs, h_last, c_last, gact, h_keep, c_keep


lstm_seq_train_fwd.launches = 0


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
    douts = (torch.zeros((T, ND, B, H), dtype=dt, device=dev) if douts is None
             else douts.to(dt).contiguous())
    # The kernel's running cotangents start from dh_last and dc_last.
    dh_state = (torch.zeros((ND, B, H), **f32) if dh_last is None
                else dh_last.to(torch.float32).contiguous().clone())
    dc_state = (torch.zeros((ND, B, H), **f32) if dc_last is None
                else dc_last.to(torch.float32).contiguous().clone())
    gbuf = torch.empty((2, ND, B, H4), dtype=torch.bfloat16, device=dev)
    dxproj = torch.empty((T, ND, B, H4), dtype=dt, device=dev)
    dw = torch.empty((ND, H, H4), **f32)
    mask_f = _mask_f32(mask)
    with torch.cuda.device(dev):
        rc = lib.vct_lstm_seq_train_bwd(
            gact.data_ptr(), int(dt == torch.bfloat16), h_keep.data_ptr(), c_keep.data_ptr(),
            w_hh.data_ptr(), _ptr(mask_f), douts.data_ptr(), dh_state.data_ptr(),
            dc_state.data_ptr(), gbuf.data_ptr(), dxproj.data_ptr(), dw.data_ptr(),
            T, ND, B, H, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "lstm_seq_train_bwd")
    lstm_seq_train_bwd.launches += 1
    return dxproj, dw


lstm_seq_train_bwd.launches = 0


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
