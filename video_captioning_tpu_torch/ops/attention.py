"""One Bahdanau attention decode step: ``attend`` under
``kernels.use_pallas_attention``.

Counterpart of video_captioning_tpu/ops/attention_pallas.py
(bahdanau_attend_pallas), with the port's linear layouts: ``w_d`` is
``decoder_projection.weight`` (A, D), ``v`` the (A,) row of
``attention_linear.weight`` and ``b_v`` its (1,) bias, kept on the device
so nothing syncs for it. Inputs h (B, D), enc_proj (B, S, A), enc_outs
(B, S, E), mask (B, S) or None (all frames valid, as the JAX wrapper
does); returns (context (B, E), weights (B, S)) in float32. Every operand
is cast to float32 first, as the JAX wrapper casts before its
``pallas_call`` (``attention_pallas.py:145-152``), so bfloat16 parameters
reach the kernel as float32. On a CUDA
tensor ``bahdanau_attend`` launches the kernel in
``csrc/bahdanau_attend.cu``; on a CPU tensor it runs
``bahdanau_attend_reference``, the eager ``attend`` math. ``attend_plan``
picks the kernel's cluster, chunks and ring from the shape (tested on the
CPU).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor

MASK_FILL = -1e9

# The row kernel: CTAs a cluster (one row's frames split over them; clusters
# of eight reach only 124 of the 132 SMs, so the main shape's 128 rows
# would leave a second wave), frames a chunk at most, the shared memory a
# CTA aims at (five CTAs an SM), the most a CTA may have (H100), and the
# most frames a CTA keeps its raw scores for in shared memory (past it they
# wait in the weights output).
ATTEND_MAX_CLUSTER = 2
ATTEND_MAX_CHUNK = 32
ATTEND_SMEM = 110 * 1024
SMEM_LIMIT = 232448
ATTEND_RAW_FRAMES = 1024


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def attend_smem(A: int, E: int, CS: int, FC: int, nst: int, frames: int) -> int:
    """Shared-memory bytes of a row-kernel plan (csrc/bahdanau_attend.cu:
    attend_layout): mbarriers, the ring, dec_proj, v, the partial context,
    two chunks' scores, the chunk's statistics, the raw scores of a CTA's
    ``frames`` and the cluster's pushed statistics and context shares."""
    return (_round16(8 * nst) + nst * _round16(4 * FC * max(A, E)) + 2 * _round16(4 * A)
            + _round16(4 * E) + _round16(8 * FC) + 16
            + (_round16(4 * frames) if frames <= ATTEND_RAW_FRAMES else 0)
            + _round16(8 * CS) + _round16(4 * CS * -(-E // CS)))


@functools.lru_cache(maxsize=256)
def attend_plan(S: int, A: int, E: int, bulk: bool) -> dict:
    """The row kernel's plan for one shape: CS = min(2, S) CTAs a row (a
    cluster, CTA r taking frames [r S / CS, (r + 1) S / CS)); chunks of
    FC <= 32 frames, as many as three slots of them fit beside the rest in
    ATTEND_SMEM (at least one), as even as a CTA's slice allows;
    ``resident`` when every chunk of enc_proj and enc_outs fits a slot of
    its own (one bulk copy each, all at entry), else a ring of ``nst``
    slots. bulk: A and E multiples of 4 and aligned operands; without it
    the kernel loads each chunk as it needs it, two slots."""
    CS = min(ATTEND_MAX_CLUSTER, S)
    frames = -(-S // CS)
    # At most 32 frames a chunk, and few enough that three slots fit.
    room = ATTEND_SMEM - attend_smem(A, E, CS, 0, 0, frames)
    n = -(-frames // max(1, min(ATTEND_MAX_CHUNK, room // (12 * max(A, E)))))
    FC = -(-frames // n)
    plan = dict(CS=CS, FC=FC, n=n, resident=False, nst=2)
    if bulk:
        fit = (max(ATTEND_SMEM, attend_smem(A, E, CS, FC, 2, frames))
               - attend_smem(A, E, CS, FC, 0, frames)) // (_round16(4 * FC * max(A, E)) + 8)
        plan.update(nst=max(2, min(2 * n, fit)), resident=fit >= 2 * n)
    plan["smem"] = attend_smem(A, E, CS, FC, plan["nst"], frames)
    return plan


def bahdanau_attend_reference(h: Tensor, w_d: Tensor, b_d: Tensor, enc_proj: Tensor,
                              enc_outs: Tensor, v: Tensor, b_v: Tensor,
                              mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Plain version: the projections, tanh, masked softmax and context sum."""
    dec_proj = h @ w_d.T + b_d                                   # (B, A)
    scores = torch.tanh(enc_proj + dec_proj[:, None, :]) @ v + b_v  # (B, S)
    if mask is not None:
        scores = torch.where(mask > 0, scores, torch.full_like(scores, MASK_FILL))
    weights = torch.softmax(scores, dim=-1)
    return (weights[:, None, :] @ enc_outs)[:, 0], weights


def _check(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask) -> None:
    B, S, A = enc_proj.shape
    D, E = h.shape[-1], enc_outs.shape[-1]
    want = {"h": (B, D), "w_d": (A, D), "b_d": (A,), "enc_proj": (B, S, A),
            "enc_outs": (B, S, E), "v": (A,), "b_v": (1,), "mask": (B, S)}
    tensors = {"h": h, "w_d": w_d, "b_d": b_d, "enc_proj": enc_proj, "enc_outs": enc_outs,
               "v": v, "b_v": b_v, "mask": mask}
    for name, shape in want.items():
        t = tensors[name]
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"bahdanau_attend takes {name} {shape} float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"bahdanau_attend: {name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"bahdanau_attend takes a contiguous {name}")


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("bahdanau_attend")
    fn = lib.vct_bahdanau_attend_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def bahdanau_attend(h: Tensor, w_d: Tensor, b_d: Tensor, enc_proj: Tensor,
                    enc_outs: Tensor, v: Tensor, b_v: Tensor,
                    mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Context (B, E) and weights (B, S) of the operands' float32 casts.
    CUDA: the kernel, on the current stream, no sync. CPU: the plain
    version."""
    h, w_d, b_d, enc_proj, enc_outs, v, b_v = (
        t.to(torch.float32).contiguous() for t in (h, w_d, b_d, enc_proj, enc_outs, v, b_v))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    if tracing():
        return torch.ops.vct.bahdanau_attend(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask)
    _check(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask)
    if h.device.type == "cpu":
        return bahdanau_attend_reference(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask)
    if h.device.type != "cuda":
        raise ValueError(f"bahdanau_attend runs on cpu or cuda, got {h.device}")
    lib = _kernel_lib()
    B, S, A = enc_proj.shape
    D, E = h.shape[-1], enc_outs.shape[-1]
    dec_proj = torch.empty((B, A), dtype=torch.float32, device=h.device)
    context = torch.empty((B, E), dtype=torch.float32, device=h.device)
    weights = torch.empty((B, S), dtype=torch.float32, device=h.device)
    if B == 0:
        return context, weights
    bulk = A % 4 == 0 and E % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (enc_proj, enc_outs, v))
    plan = attend_plan(S, A, E, bulk)
    if plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"bahdanau_attend: A = {A}, E = {E} need {plan['smem']} bytes of "
                         f"shared memory a CTA, more than the card's {SMEM_LIMIT}")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.vct_bahdanau_attend_f32(
            h.data_ptr(), w_d.data_ptr(), b_d.data_ptr(), enc_proj.data_ptr(),
            enc_outs.data_ptr(), v.data_ptr(), b_v.data_ptr(),
            None if mask is None else mask.data_ptr(), dec_proj.data_ptr(), context.data_ptr(),
            weights.data_ptr(), B, S, D, A, E, int(bulk), plan["CS"], plan["FC"], plan["nst"],
            int(plan["resident"]), stream,
        )
    check_launch(lib, rc, "bahdanau_attend")
    bahdanau_attend.launches += 1
    return context, weights


bahdanau_attend.launches = 0
