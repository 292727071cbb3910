"""LSTM parameters, the layer functions and dropout.

Counterpart of video_captioning_tpu/models/layers.py (lstm_cell,
lstm_scan, reverse_sequence, dropout). Linears and embeddings are ``nn.Linear`` /
``nn.Embedding``; an LSTM stack is :class:`LSTMWeights`, which holds its
parameters under ``torch.nn.LSTM``'s names (``weight_ih_l0``,
``bias_hh_l1_reverse``, ...) and (out, in) layout but is not an
``nn.LSTM``: the recurrence runs in the functions below or in the
``lstm_seq`` kernels. Gates are packed [i, f, g, o].

Dropout draws its keep mask from an explicit ``torch.Generator``; it cannot
reproduce ``jax.random``'s bits, so it matches the JAX package in its
statistics and placement, not in its masks.

Dtypes follow the JAX package where parameters are bfloat16 (a predictor
with ``compute_dtype="bfloat16"``): :func:`linear` and :func:`lstm_cell`
take ``matmul_default``'s rule (a float32 activation against a bfloat16
weight is rounded to bfloat16 and its products sum to a float32 result),
and the plain ``@`` / einsum sites take :func:`promote`'s (the narrower
operand is widened, exactly). In float32 every function computes what it
did before.

W8A8 decode (``models/quantize.py``) replaces a decode linear with an
:class:`Int8Linear`: per-output-channel symmetric int8 weights
(:func:`quantize_linear_int8`) and per-row dynamic activation scales
(:func:`int8_linear`), as the JAX package's ``layers.quantize_linear_int8``
and ``int8_linear``. The int8 x int8 -> int32 product is exact; on the card
it runs in cuBLASLt (``torch._int_mm``, as XLA's ``dot_general`` does on
the TPU: no Pallas kernel computes it there either).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def promote(*tensors: Tensor) -> Tuple[Tensor, ...]:
    """The tensors in their common dtype, as jnp's type promotion gives it
    (bfloat16 with float32 is float32; the widening is exact)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in tensors)


def bf16_products_f32(x: Tensor, w: Tensor) -> Tensor:
    """x (..., in) @ w (out, in).T for bfloat16 operands, float32 result:
    on CUDA a bfloat16 GEMM with float32 output where the build has one
    (``aten::mm.dtype``), else float32 products of the bfloat16 values
    (each exact) with float32 sums."""
    if x.is_cuda and hasattr(torch.ops.aten.mm, "dtype"):
        y = torch.ops.aten.mm.dtype(x.reshape(-1, x.shape[-1]), w.T, torch.float32)
        return y.reshape(x.shape[:-1] + (w.shape[0],))
    return x.float() @ w.float().T


def matmul_default(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w.T`` for a torch-layout (out, in) weight with the dtypes of
    the JAX package's ``layers.matmul_default``: a float32 activation
    against a bfloat16 weight is rounded to bfloat16 and accumulated to a
    float32 result; equal dtypes give that dtype; other mixes promote."""
    if w.dtype == torch.bfloat16 and x.dtype == torch.float32:
        return bf16_products_f32(x.to(torch.bfloat16), w)
    x, w = promote(x, w)
    return x @ w.T


def _q127(device: torch.device) -> Tensor:
    """127 as a 0-d tensor on ``device``: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the division the JAX package does."""
    return torch.full((), 127.0, dtype=torch.float32, device=device)


class Int8Linear(nn.Module):
    """A linear in W8A8 form: ``weight_q`` (out, in) int8, ``w_scale``
    (out,) float32 and ``bias`` (out,) float32 (or None), all buffers; the
    JAX form's ``kernel_q`` is ``weight_q`` transposed. Calling it is
    :func:`int8_linear`."""

    def __init__(self, weight_q: Tensor, w_scale: Tensor, bias: Optional[Tensor]):
        super().__init__()
        self.out_features, self.in_features = weight_q.shape
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)

    def forward(self, x: Tensor) -> Tensor:
        return int8_linear(self, x)


def quantize_linear_int8(mod: nn.Linear) -> Int8Linear:
    """A float linear -> W8A8: per output channel ``s = max(max|w|, 1e-8) /
    127`` and ``q = clip(round(w / s), -127, 127)`` (half to even), as the
    JAX ``quantize_linear_int8`` with the weight held (out, in)."""
    w = mod.weight.detach().float()
    s = torch.clamp(w.abs().amax(dim=1), min=1e-8) / _q127(w.device)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    bias = None if mod.bias is None else mod.bias.detach().float().clone()
    return Int8Linear(q, s, bias)


def int8_linear(mod: Int8Linear, x: Tensor) -> Tensor:
    """Dynamic-activation W8A8 product in the JAX ``int8_linear``'s order:
    per-row ``sx = max(max|x|, 1e-8) / 127``, ``xq = clip(round(x / sx),
    -127, 127)`` as int8, the exact int32 product, then ``acc * (sx *
    w_scale) + bias``, returned in ``x.dtype``."""
    from ..ops.int8_matmul import int_matmul

    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / _q127(x.device)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = int_matmul(xq.reshape(-1, x.shape[-1]), mod.weight_q)
    acc = acc.reshape(x.shape[:-1] + (mod.out_features,))
    y = acc.float() * (sx * mod.w_scale)
    if mod.bias is not None:
        y = y + mod.bias
    return y.to(x.dtype)


def linear(mod: nn.Module, x: Tensor) -> Tensor:
    """``apply_linear``: ``mod(x)`` in float32, ``matmul_default`` plus the
    bias otherwise (the bias added after the product, as in JAX), and
    :func:`int8_linear` for an :class:`Int8Linear`."""
    if isinstance(mod, Int8Linear):
        return int8_linear(mod, x)
    if getattr(mod, "vocab_split", False):  # parallel.sharding.ColumnParallelLinear
        return mod(x)
    return affine(x, mod.weight, mod.bias)


def affine(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
    """``apply_linear`` on a torch-layout (out, in) weight and its bias:
    ``F.linear`` in float32, else ``matmul_default`` and then the bias added
    (promoted as jnp promotes; in bfloat16 two roundings, as in JAX)."""
    if x.dtype == w.dtype == torch.float32:
        return F.linear(x, w, b)
    y = matmul_default(x, w)
    return y if b is None else y + b


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device: torch.device) -> Optional[Tensor]:
    """Inverted-dropout multiplier: 0 where dropped, 1/keep where kept;
    ``None`` when nothing is dropped (no generator or rate <= 0)."""
    if generator is None or rate <= 0.0:
        return None
    keep = 1.0 - rate
    kept = torch.rand(shape, generator=generator, device=device) < keep
    return kept.to(torch.float32) / keep


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> Tensor:
    """Inverted dropout as torch applies it (scale by 1/keep at train
    time); the identity unless ``train`` with a generator and rate > 0."""
    if not train:
        return x
    scale = dropout_mask(x.shape, rate, generator, x.device)
    return x if scale is None else x * scale.to(x.dtype)


class LSTMWeights(nn.Module):
    """Parameters of a (possibly bidirectional) LSTM stack."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        g4 = 4 * hidden_size
        for l in range(num_layers):
            in_dim = input_size if l == 0 else hidden_size * (2 if bidirectional else 1)
            for sfx in ("", "_reverse") if bidirectional else ("",):
                self.register_parameter(f"weight_ih_l{l}{sfx}", nn.Parameter(torch.empty(g4, in_dim)))
                self.register_parameter(f"weight_hh_l{l}{sfx}", nn.Parameter(torch.empty(g4, hidden_size)))
                self.register_parameter(f"bias_ih_l{l}{sfx}", nn.Parameter(torch.empty(g4)))
                self.register_parameter(f"bias_hh_l{l}{sfx}", nn.Parameter(torch.empty(g4)))

    def layer(self, l: int, reverse: bool = False) -> Dict[str, Tensor]:
        sfx = "_reverse" if reverse else ""
        return {
            "w_ih": getattr(self, f"weight_ih_l{l}{sfx}"),
            "w_hh": getattr(self, f"weight_hh_l{l}{sfx}"),
            "b_ih": getattr(self, f"bias_ih_l{l}{sfx}"),
            "b_hh": getattr(self, f"bias_hh_l{l}{sfx}"),
        }


def gates_tail(gates: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """Elementwise LSTM tail from gate pre-activations [i, f, g, o]."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(layer: Dict[str, Tensor], x: Tensor, h: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """One LSTM step. x: (N, in), h/c: (N, H) -> (h', c')."""
    gates = (matmul_default(x, layer["w_ih"]) + matmul_default(h, layer["w_hh"])
             + layer["b_ih"] + layer["b_hh"])
    return gates_tail(gates, c)


def lstm_scan(
    layer: Dict[str, Tensor],
    xs: Tensor,
    h0: Tensor,
    c0: Tensor,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """One LSTM layer over time in the activations' dtype (float32
    products of bfloat16 weights, as jnp's ``@`` promotes them). xs:
    (B, T, in), mask (B, T) with 1 = valid. Returns outputs (B, T, H) and
    the final (h, c).

    Masked semantics of packed sequences: at a padded step the state
    carries through and the output is zero."""
    xs_, w_ih = promote(xs, layer["w_ih"])
    xs_proj = xs_ @ w_ih.T + (layer["b_ih"] + layer["b_hh"])  # (B, T, 4H)
    w_hh_t = layer["w_hh"].T.to(torch.promote_types(h0.dtype, layer["w_hh"].dtype))
    h, c = h0, c0
    outs = []
    for t in range(xs.shape[1]):
        h_new, c_new = gates_tail(xs_proj[:, t] + h @ w_hh_t, c)
        if mask is None:
            h, c, out = h_new, c_new, h_new
        else:
            m = (mask[:, t] > 0)[:, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            out = torch.where(m, h_new, torch.zeros_like(h_new))
        outs.append(out)
    return torch.stack(outs, dim=1), (h, c)


def reverse_sequence(x: Tensor, lengths: Optional[Tensor]) -> Tensor:
    """Reverse each row's valid prefix in a padded (B, T, ...) tensor;
    positions past a row's length stay put. ``lengths=None`` flips."""
    if lengths is None:
        return torch.flip(x, dims=(1,))
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = lengths[:, None] - 1 - t
    src = torch.where(src >= 0, src, t)  # (B, T)
    src = src.reshape(src.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, src)
