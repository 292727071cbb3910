"""One fused LSTM cell step: the decoder's cell under ``kernels.use_pallas_lstm``.

Counterpart of video_captioning_tpu/ops/lstm_pallas.py (lstm_cell_pallas),
a drop-in for ``models.layers.lstm_cell``: the same layer dict (``w_ih``
(4H, In), ``w_hh`` (4H, H), ``b_ih``, ``b_hh``, in their stored layout) and
(x (N, In), h (N, H), c (N, H)) -> (h', c'), float32. Every operand is
cast to float32 first, as the JAX wrapper casts before its
``pallas_call`` (``lstm_pallas.py:113-118``): bfloat16 parameters reach
the kernel as float32, with the two biases summed in their own dtype
first, and h' and c' are float32 whatever the inputs were. On a CUDA tensor
``lstm_cell_fused`` launches the kernel in ``csrc/lstm_cell.cu``; on a CPU
tensor it runs ``lstm_cell_reference``, the plain version (float32
products). The kernel takes its products on the tensor cores by a 3xTF32
split (``csrc/tf32x3.cuh``), each within about 2^-21 of the float32
product, with float32 sums and gate math. It writes new tensors and never
its ``h``/``c`` arguments, which the beam loop's ``torch.where(active, new,
old)`` still reads.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor


def lstm_cell_reference(layer: Dict[str, Tensor], x: Tensor, h: Tensor,
                        c: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version: ``models.layers.lstm_cell`` (float32 products and
    sums on float32 operands)."""
    from ..models.layers import lstm_cell

    return lstm_cell(layer, x, h, c)


def _check(layer: Dict[str, Tensor], x: Tensor, h: Tensor, c: Tensor) -> None:
    N, In = x.shape
    H = h.shape[-1]
    want = {"x": (N, In), "h": (N, H), "c": (N, H), "w_ih": (4 * H, In),
            "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
    tensors = {"x": x, "h": h, "c": c, **layer}
    for name, shape in want.items():
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"lstm_cell takes {name} {shape} float32, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"lstm_cell: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell takes a contiguous {name}")


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("lstm_cell")
    fn = lib.vct_lstm_cell_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vct_lstm_cell_tile.argtypes = [ctypes.c_int] * 2
    lib.vct_lstm_cell_tile.restype = ctypes.c_int
    return lib


# The kernel's tiles (rows, hidden units, CTAs of a cluster that split the
# reduction axis), in the C launcher's order.
TILES = ((64, 16, 2), (64, 16, 4))


def kernel_tile(N: int, H: int) -> tuple:
    """The (rows, units, split) tile the launcher picks for N rows and H
    units on the current card."""
    i = _kernel_lib().vct_lstm_cell_tile(N, H)
    if i < 0:
        raise RuntimeError(f"lstm_cell: CUDA error {-i}")
    return TILES[i]


def float32_operands(layer: Dict[str, Tensor], x: Tensor, h: Tensor,
                     c: Tensor) -> Tuple[Dict[str, Tensor], Tensor, Tensor, Tensor]:
    """The JAX wrapper's casts: every operand to float32; a bias in
    another dtype is summed there (``b_ih + b_hh``) before its cast, and
    the sum goes in as ``b_ih`` beside a zero ``b_hh``. Float32 operands
    pass unchanged."""
    f32 = torch.float32
    if layer["b_ih"].dtype != f32 or layer["b_hh"].dtype != f32:
        bias = (layer["b_ih"] + layer["b_hh"]).to(f32)
        layer = dict(layer, b_ih=bias.contiguous(), b_hh=torch.zeros_like(bias))
    layer = {k: v.to(f32).contiguous() for k, v in layer.items()}
    return layer, x.to(f32).contiguous(), h.to(f32).contiguous(), c.to(f32).contiguous()


def lstm_cell_fused(layer: Dict[str, Tensor], x: Tensor, h: Tensor,
                    c: Tensor, tile: int = -1) -> Tuple[Tensor, Tensor]:
    """One cell step on the float32 casts of its operands
    (``float32_operands``). CUDA: the kernel, on the current stream, no
    sync; ``tile`` -1 lets the launcher pick, else an index into
    ``TILES``. CPU: the plain version."""
    layer, x, h, c = float32_operands(layer, x, h, c)
    if tracing():
        return torch.ops.vct.lstm_cell(x, h, c, layer["w_ih"], layer["w_hh"], layer["b_ih"],
                                       layer["b_hh"], tile)
    _check(layer, x, h, c)
    if x.device.type == "cpu":
        return lstm_cell_reference(layer, x, h, c)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell runs on cpu or cuda, got {x.device}")
    lib = _kernel_lib()
    N, In = x.shape
    H = h.shape[-1]
    h_out = torch.empty((N, H), dtype=torch.float32, device=x.device)
    c_out = torch.empty_like(h_out)
    if N == 0:
        return h_out, c_out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vct_lstm_cell_f32(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), layer["w_ih"].data_ptr(),
            layer["w_hh"].data_ptr(), layer["b_ih"].data_ptr(), layer["b_hh"].data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), N, In, H, tile, stream,
        )
    check_launch(lib, rc, "lstm_cell")
    lstm_cell_fused.launches += 1
    return h_out, c_out


lstm_cell_fused.launches = 0
