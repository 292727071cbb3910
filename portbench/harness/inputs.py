"""Weights and traffic inputs drawn from the run's seed.

Weights are drawn on the device by a ``torch.Generator`` in one call per
distribution (all uniform leaves from one ``torch.rand``, all normal leaves
from one ``torch.randn``) and sliced into leaves, in the dtype they are
served in (float32). The captioner's tree has the layout of the port's
inference package (JAX layout: a linear's ``kernel`` is (in, out)); the
ResNet-50's is torchvision's state dict. The same device tensors go to the
program (through a package or a weight file) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# Streams derived from the run's seed, one for each use.
WEIGHTS, POOL, SCHEDULE, SAMPLE = range(4)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream``, derived from the run's seed."""
    state = np.random.SeedSequence([int(seed) % (1 << 63), stream]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


# A leaf: (path, shape, kind, parameter); kind is "uniform" (U(-p, p)),
# "uniform_range" (U(lo, hi) for p = (lo, hi)), "normal" (N(0, p^2)) or
# "one_plus_normal" (1 + N(0, p^2)).
Leaf = Tuple[tuple, Tuple[int, ...], str, object]


def _linear(path: tuple, n_in: int, n_out: int, bound: float) -> List[Leaf]:
    return [(path + ("kernel",), (n_in, n_out), "uniform", bound),
            (path + ("bias",), (n_out,), "normal", 0.02)]


def _ln(path: tuple, d: int) -> List[Leaf]:
    return [(path + ("scale",), (d,), "one_plus_normal", 0.1),
            (path + ("bias",), (d,), "normal", 0.02)]


def lstm_captioner_leaves(m: dict, V: int) -> List[Leaf]:
    """The LSTM family's tree: BiLSTM encoder, Bahdanau attention LSTM
    decoder with a deep output. Linears torch-default uniform (xavier for
    the context and vocabulary projections), LSTMs U(1/sqrt(H))."""
    F, E, D = m["cnn_feature_dim"], m["encoder_hidden_dim"], m["decoder_hidden_dim"]
    emb, A = m["embedding_dim"], m["attention_dim"]
    leaves: List[Leaf] = _linear(("encoder", "feature_projection"), F, E, 1 / math.sqrt(F))
    for l in range(m["encoder_num_layers"]):
        n_in = E if l == 0 else 2 * E
        for d in ("fwd", "bwd"):
            p = ("encoder", "lstm", l, d)
            b = 1 / math.sqrt(E)
            leaves += [(p + ("w_ih",), (n_in, 4 * E), "uniform", b),
                       (p + ("w_hh",), (E, 4 * E), "uniform", b),
                       (p + ("b_ih",), (4 * E,), "uniform", b),
                       (p + ("b_hh",), (4 * E,), "uniform", b)]
    leaves += _linear(("encoder", "output_projection"), 2 * E, E, 1 / math.sqrt(2 * E))
    leaves.append((("decoder", "embedding", "table"), (V, emb), "uniform", 0.1))
    for l in range(m["decoder_num_layers"]):
        n_in = emb + E if l == 0 else D
        p = ("decoder", "lstm", l)
        b = 1 / math.sqrt(D)
        leaves += [(p + ("w_ih",), (n_in, 4 * D), "uniform", b),
                   (p + ("w_hh",), (D, 4 * D), "uniform", b),
                   (p + ("b_ih",), (4 * D,), "uniform", b),
                   (p + ("b_hh",), (4 * D,), "uniform", b)]
    leaves += _linear(("decoder", "output_projection"), D, V, math.sqrt(6 / (D + V)))
    att = ("decoder", "attention")
    leaves += _linear(att + ("encoder_projection",), E, A, 1 / math.sqrt(E))
    leaves += _linear(att + ("decoder_projection",), D, A, 1 / math.sqrt(D))
    leaves += _linear(att + ("attention_linear",), A, 1, 1 / math.sqrt(A))
    leaves += _linear(("decoder", "context_projection"), E + D + emb, D,
                      math.sqrt(6 / (E + D + emb + D)))
    if E != D:
        leaves += _linear(("decoder", "init_state_projection"), E, D, 1 / math.sqrt(E))
    return leaves


def transformer_captioner_leaves(m: dict, V: int) -> List[Leaf]:
    """The transformer family's tree: pre-LN encoder and decoder blocks,
    xavier-uniform attention, MLP and vocabulary kernels, 0.02 N(0, 1)
    position tables and embedding."""
    F, D, r = m["cnn_feature_dim"], m["decoder_hidden_dim"], m["transformer_mlp_ratio"]
    xav = math.sqrt(6 / (2 * D))

    def attn(p):
        return sum((_linear(p + (n,), D, D, xav) for n in ("wq", "wk", "wv", "wo")), [])

    def mlp(p):
        b = math.sqrt(6 / (D + r * D))
        return _linear(p + ("fc1",), D, r * D, b) + _linear(p + ("fc2",), r * D, D, b)

    leaves: List[Leaf] = _linear(("encoder", "feature_projection"), F, D, 1 / math.sqrt(F))
    leaves.append((("encoder", "pos_embedding"), (m["video_sequence_length"], D), "normal", 0.02))
    for i in range(m["transformer_num_layers"]):
        p = ("encoder", "blocks", i)
        leaves += _ln(p + ("ln1",), D) + attn(p + ("self_attn",)) + _ln(p + ("ln2",), D)
        leaves += mlp(p + ("mlp",))
    leaves += _ln(("encoder", "ln_f"), D)
    leaves.append((("decoder", "embedding", "table"), (V, D), "normal", 0.02))
    leaves.append((("decoder", "pos_embedding"), (m["max_sequence_length"] + 1, D), "normal",
                   0.02))
    for i in range(m["transformer_decoder_layers"]):
        p = ("decoder", "blocks", i)
        leaves += _ln(p + ("ln1",), D) + attn(p + ("self_attn",)) + _ln(p + ("ln2",), D)
        leaves += attn(p + ("cross_attn",)) + _ln(p + ("ln3",), D) + mlp(p + ("mlp",))
    leaves += _ln(("decoder", "ln_f"), D)
    leaves += _linear(("decoder", "output_projection"), D, V, math.sqrt(6 / (D + V)))
    return leaves


RESNET_BLOCKS = (3, 4, 6, 3)
RESNET_WIDTHS = (64, 128, 256, 512)


def resnet50_leaves() -> List[Leaf]:
    """torchvision's ResNet-50 state dict without fc: He-normal fan-out
    convs (OIHW), BN scale U(0.8, 1.2), bias and running mean 0.05 N(0, 1),
    running variance U(0.5, 1.5), so folding is not the identity."""
    def conv(name, cout, cin, k):
        return [((f"{name}.weight",), (cout, cin, k, k), "normal", math.sqrt(2 / (k * k * cout)))]

    def bn(name, c):
        return [((f"{name}.weight",), (c,), "uniform_range", (0.8, 1.2)),
                ((f"{name}.bias",), (c,), "normal", 0.05),
                ((f"{name}.running_mean",), (c,), "normal", 0.05),
                ((f"{name}.running_var",), (c,), "uniform_range", (0.5, 1.5))]

    leaves = conv("conv1", 64, 3, 7) + bn("bn1", 64)
    cin = 64
    for s, (n, w) in enumerate(zip(RESNET_BLOCKS, RESNET_WIDTHS)):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            leaves += conv(f"{p}.conv1", w, cin, 1) + bn(f"{p}.bn1", w)
            leaves += conv(f"{p}.conv2", w, w, 3) + bn(f"{p}.bn2", w)
            leaves += conv(f"{p}.conv3", 4 * w, w, 1) + bn(f"{p}.bn3", 4 * w)
            if b == 0:
                leaves += conv(f"{p}.downsample.0", 4 * w, cin, 1) + bn(f"{p}.downsample.1", 4 * w)
            cin = 4 * w
    return leaves


def draw(leaves: List[Leaf], gen: torch.Generator, device) -> Dict[tuple, torch.Tensor]:
    """Every leaf drawn in two large calls (uniform, normal), float32."""
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    uni = [i for i, lf in enumerate(leaves) if lf[2] in ("uniform", "uniform_range")]
    nor = [i for i, lf in enumerate(leaves) if lf[2] in ("normal", "one_plus_normal")]
    u = torch.rand(sum(sizes[i] for i in uni), generator=gen, device=device)
    n = torch.randn(sum(sizes[i] for i in nor), generator=gen, device=device)
    out: Dict[tuple, torch.Tensor] = {}
    offsets = {"u": 0, "n": 0}
    for i, (path, shape, kind, param) in enumerate(leaves):
        size = sizes[i]
        if kind in ("uniform", "uniform_range"):
            x = u[offsets["u"]:offsets["u"] + size]
            offsets["u"] += size
            lo, hi = (-param, param) if kind == "uniform" else param
            x = x * (hi - lo) + lo
        else:
            x = n[offsets["n"]:offsets["n"] + size]
            offsets["n"] += size
            x = x * param + (1.0 if kind == "one_plus_normal" else 0.0)
        out[path] = x.reshape(shape)
    return out


def nest(flat: Dict[tuple, torch.Tensor]) -> dict:
    """{("a", 0, "b"): t} -> {"a": [{"b": t}]}: integer keys become lists."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[k]) for k in sorted(node)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def captioner_weights(config: dict, seed: int, device) -> dict:
    """The captioner's JAX-layout tree of device tensors, with the
    configuration's vocabulary sharpening and END suppression applied."""
    m, w = config["model"], config["weights"]
    V = m["vocab_size"]
    family = m.get("architecture", "lstm")
    leaves = (transformer_captioner_leaves(m, V) if family == "transformer"
              else lstm_captioner_leaves(m, V))
    tree = nest(draw(leaves, generator(seed, WEIGHTS, device), device))
    proj = tree["decoder"]["output_projection"]
    proj["kernel"].mul_(float(w["vocab_sharpen"]))
    if w.get("suppress_end"):
        proj["bias"][int(w["end_idx"])] = -1e9
    return tree


def resnet50_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    flat = draw(resnet50_leaves(), generator(seed, WEIGHTS, device), device)
    return {path[0]: t for path, t in flat.items()}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def feature_pool(n: int, frames: int, dim: int, seed: int, device) -> np.ndarray:
    """(n, frames, dim) float32 host clips, ReLU(N(0, 1)) like fc7 / pool
    features, drawn on the device in one call."""
    g = generator(seed, POOL, device)
    x = torch.randn((n, frames, dim), generator=g, device=device).clamp_(min=0.0)
    return x.cpu().numpy()


def frame_pool(n: int, frames: int, height: int, width: int, seed: int, device) -> np.ndarray:
    """(n, frames, height, width, 3) uint8 host clips of decoded frames."""
    g = generator(seed, POOL, device)
    x = torch.randint(0, 256, (n, frames, height, width, 3), generator=g, device=device,
                      dtype=torch.uint8)
    return x.cpu().numpy()


def clip_order(seed: int, pool: int, count: int) -> np.ndarray:
    """``count`` clip indices: whole permutations of the pool, one after
    another, each drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, SCHEDULE))
    reps = -(-count // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:count]


def sample_indices(seed: int, n: int, k: int) -> np.ndarray:
    """``k`` of ``n`` finished requests, drawn from the seed, in order."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
