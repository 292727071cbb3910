"""Sharding rules: how parameters and batches lay out over the (data,
model) mesh, and the collectives that implement them.

Counterpart of video_captioning_tpu/parallel/sharding.py, with its rules
(the JAX package lets XLA insert the collectives; here they are written
out):

* **Batch**: the leading axis over ``data`` (``shard_batch``): each data
  index takes its own block of rows. The train step sums the gradients
  over the ``data`` group (``all_reduce_gradients``).
* **Parameters**: replicated, except the vocabulary-sized matrices, split
  over ``model`` (``param_specs``, keyed by the port's upstream parameter
  names, the layouts of ``models/weights.py``):
  - the decoder embedding table, torch ``(V, emb)``: vocabulary rows;
  - the decoder output projection, JAX kernel ``(H, V)`` = torch weight
    ``(V, H)``, and its bias ``(V,)``: vocabulary columns.
  ``shard_model`` applies the split: a vocabulary-parallel embedding
  (masked lookup of the local rows, then ``all_reduce``) and a
  column-parallel projection whose logits are ``all_gather``ed, so the
  loss, the top-k and the tokens see the unsplit logits. With
  ``model_axis == 1`` nothing is split and no collective or copy is made,
  so the same train step serves one device and many.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: one mesh axis name (or None) per array axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: P


VOCAB_ROWS = ("decoder.embedding.weight", "decoder.output_projection.weight")
VOCAB_VECTORS = ("decoder.output_projection.bias",)


def batch_spec() -> P:
    return P("data")


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_spec(name: str) -> P:
    """The spec of one parameter of the port's state dict (torch layout)."""
    if name in VOCAB_ROWS:
        return P("model", None)
    if name in VOCAB_VECTORS:
        return P("model")
    return P()


def param_specs(params: Mapping[str, Any]) -> Dict[str, P]:
    """Specs keyed like ``params`` (a state dict or ``named_parameters``)."""
    return {name: param_spec(name) for name in dict(params)}


def param_shardings(mesh: Mesh, params: Mapping[str, Any]) -> Dict[str, NamedSharding]:
    return {name: NamedSharding(mesh, spec) for name, spec in param_specs(params).items()}


def shard_batch(mesh: Mesh, batch: dict, index: Optional[int] = None) -> dict:
    """The rows of a global numpy batch that data index ``index`` (default:
    this process's) takes: block ``index`` of ``mesh.shape['data']`` equal
    blocks of the leading axis. Entries without a shape pass through."""
    n = mesh.shape["data"]
    i = mesh.axis_index("data") if index is None else index
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1:
            if v.shape[0] % n:
                raise ValueError(f"batch of {v.shape[0]} rows does not split over the data "
                                 f"axis ({n} devices)")
            rows = v.shape[0] // n
            v = v[i * rows:(i + 1) * rows]
        out[k] = v
    return out


# ---------------------------------------------------------------- collectives


def _all_gather_last(x: Tensor, group) -> Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _GatherColumns(torch.autograd.Function):
    """Forward: the model group's column blocks side by side. Backward:
    this rank's block of the gradient (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.cols = x.shape[-1]
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        i = dist.get_rank(ctx.group)
        return grad[..., i * ctx.cols:(i + 1) * ctx.cols].contiguous(), None


class _SumForward(torch.autograd.Function):
    """Forward: ``all_reduce`` SUM over the group. Backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """Forward: identity. Backward: ``all_reduce`` SUM of the gradient
    (the input feeds every rank's block of a column-split product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Group:
    """A process group held by a module: ``copy.deepcopy`` of the module
    (the trainer's evaluation copy) shares it."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class VocabParallelEmbedding(nn.Embedding):
    """An embedding holding rows [start, start + rows) of the table: a
    token outside them reads zero, and the sum over the model group is the
    unsplit lookup."""

    vocab_split = True

    def __init__(self, weight: Tensor, start: int, vocab_size: int, group):
        super().__init__(weight.shape[0], weight.shape[1], _weight=weight.detach().clone())
        self.start, self.vocab_size, self._group = start, vocab_size, _Group(group)

    def forward(self, tokens: Tensor) -> Tensor:
        local = tokens - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        rows = rows * inside[..., None].to(rows.dtype)
        return _SumForward.apply(rows, self._group.group)


class ColumnParallelLinear(nn.Linear):
    """A linear holding output columns [start, start + cols): its forward
    gives the gathered (unsplit) outputs. ``models.layers.linear`` calls
    it (the ``vocab_split`` mark)."""

    vocab_split = True

    def __init__(self, weight: Tensor, bias: Optional[Tensor], start: int, out_features: int,
                 group):
        super().__init__(weight.shape[1], weight.shape[0], bias=bias is not None,
                         device=weight.device, dtype=weight.dtype)
        with torch.no_grad():
            self.weight.copy_(weight)
            if bias is not None:
                self.bias.copy_(bias)
        self.start, self.full_out_features, self._group = start, out_features, _Group(group)

    def forward(self, x: Tensor) -> Tensor:
        from ..models.layers import matmul_default

        group = self._group.group
        x = _SumBackward.apply(x, group)
        if x.dtype == self.weight.dtype == torch.float32:
            y = F.linear(x, self.weight, self.bias)
        else:
            y = matmul_default(x, self.weight)
            y = y if self.bias is None else y + self.bias
        return _GatherColumns.apply(y, group)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split the model's vocabulary matrices over ``mesh``'s model axis in
    place (this rank's block of rows / columns); a no-op at model size 1."""
    M = mesh.shape["model"]
    if M == 1:
        return model
    dec = model.decoder
    V = dec.output_projection.weight.shape[0]
    if V % M:
        raise ValueError(f"vocabulary of {V} does not split over model_axis={M}")
    rows, m, group = V // M, mesh.axis_index("model"), mesh.group("model")
    sl = slice(m * rows, (m + 1) * rows)
    emb, proj = dec.embedding, dec.output_projection
    dec.embedding = VocabParallelEmbedding(emb.weight[sl], m * rows, V, group)
    dec.output_projection = ColumnParallelLinear(
        proj.weight[sl], None if proj.bias is None else proj.bias[sl], m * rows, V, group)
    return model


def gather_rows(t: Tensor, mesh: Mesh) -> Tensor:
    """The model group's blocks of a row-split tensor, in order (a
    collective: every rank of the group calls it)."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, t.contiguous(), group=mesh.group("model"))
    return torch.cat(parts, dim=0)


def local_rows(t: Tensor, mesh: Mesh) -> Tensor:
    """This rank's block of rows of an unsplit tensor."""
    rows = t.shape[0] // mesh.shape["model"]
    m = mesh.axis_index("model")
    return t[m * rows:(m + 1) * rows].contiguous()


def gather_state_dict(state: Mapping[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """The unsplit state dict of a (possibly split) model's."""
    if mesh.shape["model"] == 1:
        return dict(state)
    return {k: gather_rows(v, mesh) if param_spec(k) else v for k, v in state.items()}


def local_state_dict(state: Mapping[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """``gather_state_dict``'s inverse: this rank's block of each split
    entry of an unsplit state dict."""
    if mesh.shape["model"] == 1:
        return dict(state)
    return {k: local_rows(v, mesh) if param_spec(k) else v for k, v in state.items()}


def split_names(model: nn.Module) -> List[str]:
    return [n for n, _ in model.named_parameters() if param_spec(n)]


def all_reduce_gradients(params: List[nn.Parameter], mesh: Mesh) -> None:
    """Sum every gradient over the data group, in one flat buffer."""
    group = mesh.group("data")
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def global_grad_norm(named: List[tuple], mesh: Optional[Mesh]) -> Tensor:
    """The norm of the whole (unsplit) gradient: the split parameters'
    squares are summed over the model group, the replicated ones counted
    once."""
    rep = [p.grad for n, p in named if p.grad is not None and not param_spec(n)]
    split = [p.grad for n, p in named if p.grad is not None and param_spec(n)]
    sq = sum((g.float() ** 2).sum() for g in rep)
    if split:
        part = sum((g.float() ** 2).sum() for g in split)
        if mesh is not None and mesh.group("model") is not None:
            part = part.clone()
            dist.all_reduce(part, group=mesh.group("model"))
        sq = sq + part
    return torch.sqrt(sq)
