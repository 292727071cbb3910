"""The serving kernels as ``torch.library`` custom ops (namespace ``vct``).

Each op has a CUDA implementation (its wrapper's kernel launch, which
counts in the wrapper's ``launches``), a CPU implementation (the plain
version) and a fake one (output shapes and dtypes) for tracing. The
wrappers call the op instead of running themselves while
``torch.compiler.is_compiling()`` (``torch.export``), so an exported
program holds ``vct::`` nodes that launch the kernels, and count, when it
runs on the card. Importing this module (``ops/__init__`` does) registers
the ops: ``inference.export.ExportedPredictor`` needs nothing else to run a
program. Eager calls go straight to the wrappers, as before.
"""

from __future__ import annotations

import importlib
from typing import Optional, Tuple

import torch

# The modules (``ops/__init__`` binds some of their names to functions).
(attention, bottleneck, conv1x1, int8_matmul, lstm_cell, lstm_seq, topk, transformer_attn,
 vocab_topk) = (importlib.import_module(f".{m}", __package__) for m in (
    "attention", "bottleneck", "conv1x1", "int8_matmul", "lstm_cell", "lstm_seq", "topk",
    "transformer_attn", "vocab_topk"))

Tensor = torch.Tensor
NAMESPACE = "vct"


def _fresh(out, inputs):
    """Outputs that alias no input (a custom op's contract), contiguous."""
    single = isinstance(out, Tensor)
    outs = (out,) if single else tuple(out)
    ptrs = {t.untyped_storage().data_ptr() for t in inputs if isinstance(t, Tensor)}
    outs = tuple(o.clone() if o.untyped_storage().data_ptr() in ptrs or not o.is_contiguous()
                 else o for o in outs)
    return outs[0] if single else outs


def _op(name: str, cpu):
    """Register ``fn`` as ``vct::name``: ``fn`` itself on CUDA (the wrapper's
    kernel path), ``cpu`` (the plain version) on the CPU."""
    def register(fn):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", fn, mutates_args=(),
                                     device_types="cuda")
        op.register_kernel("cpu")(lambda *a: _fresh(cpu(*a), a))
        return op
    return register


# ------------------------------------------------------------- decode ops


@_op("lstm_seq", lambda x, w, m: _flat_seq(lstm_seq.lstm_seq_reference(x, w, m)))
def lstm_seq_op(xproj: Tensor, w_hh: Tensor, mask: Optional[Tensor]
                ) -> Tuple[Tensor, Tensor, Tensor]:
    return _flat_seq(lstm_seq.lstm_seq(xproj, w_hh, mask))


def _flat_seq(out):
    outs, (h, c) = out
    return outs, h, c


@lstm_seq_op.register_fake
def _(xproj, w_hh, mask):
    T, ND, B, H4 = xproj.shape
    return (xproj.new_empty((T, ND, B, H4 // 4)), xproj.new_empty((ND, B, H4 // 4)),
            xproj.new_empty((ND, B, H4 // 4)))


@_op("topk2d_lse", topk.topk2d_lse_reference)
def topk2d_lse_op(x: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    return topk.topk2d_lse(x, k)


@topk2d_lse_op.register_fake
def _(x, k):
    N = x.shape[0]
    return (x.new_empty((N, k), dtype=torch.float32), x.new_empty((N, k), dtype=torch.int32),
            x.new_empty((N,), dtype=torch.float32))


@_op("topk2d", topk.topk2d_reference)
def topk2d_op(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    return topk.topk2d(x, k)


@topk2d_op.register_fake
def _(x, k):
    N = x.shape[0]
    return x.new_empty((N, k), dtype=torch.float32), x.new_empty((N, k), dtype=torch.int32)


def _cell_layer(w_ih, w_hh, b_ih, b_hh):
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}


@_op("lstm_cell", lambda x, h, c, w_ih, w_hh, b_ih, b_hh, tile: lstm_cell.lstm_cell_reference(
    _cell_layer(w_ih, w_hh, b_ih, b_hh), x, h, c))
def lstm_cell_op(x: Tensor, h: Tensor, c: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor,
                 b_hh: Tensor, tile: int) -> Tuple[Tensor, Tensor]:
    return lstm_cell.lstm_cell_fused(_cell_layer(w_ih, w_hh, b_ih, b_hh), x, h, c, tile)


@lstm_cell_op.register_fake
def _(x, h, c, w_ih, w_hh, b_ih, b_hh, tile):
    return h.new_empty(h.shape), h.new_empty(h.shape)


@_op("bahdanau_attend", attention.bahdanau_attend_reference)
def bahdanau_attend_op(h: Tensor, w_d: Tensor, b_d: Tensor, enc_proj: Tensor, enc_outs: Tensor,
                       v: Tensor, b_v: Tensor, mask: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    return attention.bahdanau_attend(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask)


@bahdanau_attend_op.register_fake
def _(h, w_d, b_d, enc_proj, enc_outs, v, b_v, mask):
    B, S, _ = enc_proj.shape
    return h.new_empty((B, enc_outs.shape[-1])), h.new_empty((B, S))


@_op("vocab_topk_lse", vocab_topk.vocab_topk_lse_reference)
def vocab_topk_lse_op(x: Tensor, w_padded: Tensor, b_padded: Tensor,
                      k: int) -> Tuple[Tensor, Tensor, Tensor]:
    return vocab_topk.vocab_topk_lse(x, w_padded, b_padded, k)


@vocab_topk_lse_op.register_fake
def _(x, w_padded, b_padded, k):
    N = x.shape[0]
    return (x.new_empty((N, k), dtype=torch.float32), x.new_empty((N, k), dtype=torch.int32),
            x.new_empty((N,), dtype=torch.float32))


@_op("beam_self_attention", transformer_attn.beam_self_attention_reference)
def beam_self_attention_op(q: Tensor, k_lyr: Tensor, v_lyr: Tensor, anc: Tensor, t: int,
                           num_heads: int, num_beams: int) -> Tensor:
    return transformer_attn.beam_self_attention(q, k_lyr, v_lyr, anc, t, num_heads, num_beams)


@beam_self_attention_op.register_fake
def _(q, k_lyr, v_lyr, anc, t, num_heads, num_beams):
    return q.new_empty(q.shape)


@_op("beam_cross_attention", transformer_attn.beam_cross_attention_reference)
def beam_cross_attention_op(q: Tensor, ck: Tensor, cv: Tensor, mask: Optional[Tensor],
                            num_heads: int, num_beams: int) -> Tuple[Tensor, Tensor]:
    return transformer_attn.beam_cross_attention(q, ck, cv, mask, num_heads, num_beams)


@beam_cross_attention_op.register_fake
def _(q, ck, cv, mask, num_heads, num_beams):
    return q.new_empty(q.shape), q.new_empty((q.shape[0], ck.shape[1]))


# --------------------------------------------------------- extraction ops


@_op("fused_bottleneck", bottleneck.fused_bottleneck_reference)
def fused_bottleneck_op(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, w3: Tensor,
                        b3: Tensor) -> Tensor:
    return bottleneck.fused_bottleneck(x, w1, b1, w2, b2, w3, b3)


@fused_bottleneck_op.register_fake
def _(x, w1, b1, w2, b2, w3, b3):
    return x.new_empty(x.shape)


@_op("matmul_bias_act", lambda x, w, b, r, relu: conv1x1.matmul_bias_act_reference(
    x, w, b, r, relu=relu))
def matmul_bias_act_op(x: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor],
                       relu: bool) -> Tensor:
    return conv1x1.matmul_bias_act(x, w, b, residual, relu=relu)


@matmul_bias_act_op.register_fake
def _(x, w, b, residual, relu):
    return x.new_empty((x.shape[0], w.shape[0]))


def _int8_out(xq, wq, s_out):
    dtype = torch.float32 if s_out is None else torch.int8
    return xq.new_empty((xq.shape[0], wq.shape[0]), dtype=dtype)


@_op("int8_matmul_requant", int8_matmul.int8_matmul_requant_reference)
def int8_matmul_requant_op(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor,
                           s_out: Optional[float], relu: bool) -> Tensor:
    return int8_matmul.int8_matmul_requant(xq, wq, scale, bias, s_out, relu)


@int8_matmul_requant_op.register_fake
def _(xq, wq, scale, bias, s_out, relu):
    return _int8_out(xq, wq, s_out)


@_op("int8_matmul_residual_requant", int8_matmul.int8_matmul_residual_requant_reference)
def int8_matmul_residual_requant_op(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor,
                                    idq: Tensor, s_id: float, s_out: Optional[float]) -> Tensor:
    return int8_matmul.int8_matmul_residual_requant(xq, wq, scale, bias, idq, s_id, s_out)


@int8_matmul_residual_requant_op.register_fake
def _(xq, wq, scale, bias, idq, s_id, s_out):
    return _int8_out(xq, wq, s_out)


CUSTOM_OPS = (lstm_seq_op, topk2d_lse_op, topk2d_op, lstm_cell_op, bahdanau_attend_op,
              vocab_topk_lse_op, beam_self_attention_op, beam_cross_attention_op,
              fused_bottleneck_op, matmul_bias_act_op, int8_matmul_requant_op,
              int8_matmul_residual_requant_op)

