"""Fused vocabulary projection + exact top-k + logsumexp: the beam step's
expansion under ``kernels.use_fused_vocab_topk``.

Counterpart of video_captioning_tpu/ops/vocab_topk_pallas.py
(pad_vocab_weights, vocab_topk_lse), with its layouts: the kernel (H, V),
the bias (V,). ``pad_vocab_weights`` runs once per generation call; on a
CUDA tensor ``vocab_topk_lse`` launches the kernels in
``csrc/vocab_topk.cu`` over the partition ``vocab_partition`` picks, on a
CPU tensor it runs ``vocab_topk_lse_reference``, the plain version of the same contract:
x rounded to bf16, exact bf16 products summed in float32, plus the
float32 bias; top-k values and indices in ``lax.top_k``'s order, exact
given the logits; the lse to float32 rounding. (The kernel's tensor cores
round their float32 sums their own way: its logits match the plain
version's to about 1e-6 of their scale.)
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import check_launch, load_library, tracing
from .topk import MAX_K, topk_stable

Tensor = torch.Tensor

PAD_FILL = torch.finfo(torch.float32).min


def pad_vocab_weights(kernel: Tensor, bias: Tensor, vt: int = 128) -> Tuple[Tensor, Tensor, int]:
    """Pad (H, V) weights and the (V,) bias to a multiple of ``vt`` columns
    and cast the weights to bf16. The pad bias is float32-min, so padded
    tokens are never selected and add exp() = 0 to the logsumexp. Call it
    outside the decode loop. ``vt`` must be a multiple of 8 (the kernel
    copies weight rows in 16-byte pieces)."""
    if vt % 8:
        raise ValueError(f"pad_vocab_weights needs vt a multiple of 8, got {vt}")
    H, V = kernel.shape
    v_padded = -(-V // vt) * vt
    w = torch.zeros((H, v_padded), dtype=torch.bfloat16, device=kernel.device)
    w[:, :V] = kernel.detach()
    b = torch.full((v_padded,), PAD_FILL, dtype=torch.float32, device=bias.device)
    b[:V] = bias.detach()
    return w, b, v_padded


def vocab_topk_lse_reference(x: Tensor, w_padded: Tensor, b_padded: Tensor,
                             k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version: ((N, k) f32 values, (N, k) int32 indices, (N,) f32
    lse) of ``bf16(x) @ W + b``."""
    logits = x.to(torch.bfloat16).float() @ w_padded.float() + b_padded
    vals, idx = topk_stable(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=-1)


def _check(x: Tensor, w_padded: Tensor, b_padded: Tensor, k: int) -> None:
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"vocab_topk_lse takes a contiguous (N, H) float32 x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    N, H = x.shape
    if (w_padded.dtype != torch.bfloat16 or w_padded.ndim != 2 or w_padded.shape[0] != H
            or w_padded.shape[1] % 8 or not w_padded.is_contiguous()):
        raise ValueError(f"vocab_topk_lse takes a contiguous ({H}, Vp) bfloat16 weight with "
                         f"Vp % 8 == 0 (pad_vocab_weights), got {w_padded.dtype} "
                         f"{tuple(w_padded.shape)}")
    Vp = w_padded.shape[1]
    if b_padded.dtype != torch.float32 or tuple(b_padded.shape) != (Vp,):
        raise ValueError(f"vocab_topk_lse takes a ({Vp},) float32 bias, got {b_padded.dtype} "
                         f"{tuple(b_padded.shape)}")
    for name, t in (("w_padded", w_padded), ("b_padded", b_padded)):
        if t.device != x.device:
            raise ValueError(f"vocab_topk_lse: {name} is on {t.device}, x on {x.device}")
    if not 1 <= k <= min(MAX_K, Vp):
        raise ValueError(f"vocab_topk_lse needs 1 <= k <= min(16, Vp), got k={k}, Vp={Vp}")


# The kernel's fixed shapes (csrc/vocab_topk.cu): vocabulary columns of a
# tile, the k-chunk H is padded to, weight ring stages of 64 x 128 bf16.
TILE_COLS = 128
K_CHUNK = 64
RING_STAGES = 4
STAGE_BYTES = 64 * TILE_COLS * 2
MAX_SMEM = 232448  # bytes of shared memory a CTA can use on an H100


def vocab_smem_bytes(rows: int, h_pad: int) -> int:
    """Dynamic shared memory of one CTA (csrc/vocab_topk.cu:smem_bytes):
    barriers and two tiles of bias, the weight ring, the resident x block,
    the product threads' stash of 32 floats each (two of them a row)."""
    return 2048 + RING_STAGES * STAGE_BYTES + rows * h_pad * 2 + 2 * rows * 32 * 4


def vocab_row_block_fits(H: int) -> bool:
    """Whether ``vocab_partition`` finds a row block for H: the smallest
    block, 64 rows of the padded bf16 x, fits in shared memory beside the
    ring (H up to 1152)."""
    return vocab_smem_bytes(64, -(-H // K_CHUNK) * K_CHUNK) <= MAX_SMEM


def vocab_partition(N: int, H: int, Vp: int, n_sm: int) -> dict:
    """How the kernel splits the work: row blocks of ``rows`` rows (128, or
    64 where a 128-row bf16 x block does not fit in shared memory beside
    the ring) times ``spans`` spans of ``tiles_per_span`` consecutive
    vocabulary tiles, as many CTAs as fill one wave of ``n_sm`` SMs;
    ``h_pad`` is H rounded up to the kernel's k-chunk. Every span is
    non-empty and the spans cover each tile once. Raises where H is too
    large for a 64-row block."""
    h_pad = -(-H // K_CHUNK) * K_CHUNK
    fits = [r for r in (128, 64) if vocab_smem_bytes(r, h_pad) <= MAX_SMEM]
    if not vocab_row_block_fits(H):
        raise ValueError(f"vocab_topk_lse: H={H} leaves no room for a row block in shared memory")
    rows = fits[0]
    row_blocks = -(-N // rows)
    tiles = -(-Vp // TILE_COLS)
    spans = max(1, min(tiles, n_sm // row_blocks))
    tiles_per_span = -(-tiles // spans)
    spans = -(-tiles // tiles_per_span)
    return dict(rows=rows, row_blocks=row_blocks, h_pad=h_pad, tiles=tiles, spans=spans,
                tiles_per_span=tiles_per_span)


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("vocab_topk")
    fn = lib.vct_vocab_topk_lse
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def vocab_topk_lse(x: Tensor, w_padded: Tensor, b_padded: Tensor,
                   k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(top-k values, top-k indices int32, logsumexp) of ``bf16(x) @ W + b``
    rows, x rounded to bfloat16 whatever its dtype, as the JAX wrapper
    casts it (``vocab_topk_pallas.py:211``; a bfloat16 x goes in through
    its exact float32 widening). CUDA: the kernels, on the current stream,
    no sync. CPU: the plain version."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32).contiguous()
    if tracing():
        return torch.ops.vct.vocab_topk_lse(x, w_padded, b_padded, k)
    _check(x, w_padded, b_padded, k)
    if x.device.type == "cpu":
        return vocab_topk_lse_reference(x, w_padded, b_padded, k)
    if x.device.type != "cuda":
        raise ValueError(f"vocab_topk_lse runs on cpu or cuda, got {x.device}")
    N, H = x.shape
    Vp = w_padded.shape[1]
    dev = x.device
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return vals, idx, lse
    part = vocab_partition(N, H, Vp, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _kernel_lib()
    spans = part["spans"]
    x16 = torch.empty((N, part["h_pad"]), dtype=torch.bfloat16, device=dev)
    part_v = torch.empty((N, spans, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((N, spans, k), dtype=torch.int32, device=dev)
    part_ms = torch.empty((2, N, spans), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vct_vocab_topk_lse(
            x.data_ptr(), w_padded.data_ptr(), b_padded.data_ptr(), x16.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), part_ms[0].data_ptr(), part_ms[1].data_ptr(),
            vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), N, H, part["h_pad"], Vp, k,
            part["rows"], part["tiles_per_span"], spans, stream,
        )
    check_launch(lib, rc, "vocab_topk_lse")
    vocab_topk_lse.launches += 1
    return vals, idx, lse


vocab_topk_lse.launches = 0
