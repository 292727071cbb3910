"""The weight bridge between the JAX parameter pytree and the port's
``state_dict``, and a numpy initializer for that pytree.

The port names its parameters as the upstream torch model does
(``encoder.lstm.weight_hh_l1_reverse``, ``decoder.attention.
encoder_projection.weight``, ...) in torch's (out, in) layout: the names
and layout that video_captioning_tpu/models/torch_port.py
(import_reference_state_dict) reads. ``state_dict_from_jax_params`` maps
the JAX pytree to the port's ``state_dict``; ``jax_params_from_state_dict``
is its exact inverse, so the checkpoints and packages the port writes hold
the JAX pytree and load in the JAX package.

Every inference package stores the JAX pytree as numpy arrays
(``model_state_dict``); :func:`init_params_numpy` makes such a pytree from a
numpy seed with the distributions of the JAX package's ``init_model``
(models/layers.py), so a package can be written where no JAX is installed.
The random streams differ from JAX's; only the distributions match.

The transformer family has no upstream torch model, so its names follow
the JAX pytree paths (``decoder.blocks.0.cross_attn.wq.weight``), with a
layer norm's ``scale`` as ``weight`` and the embedding ``table`` as
``decoder.embedding.weight``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config

Tensor = torch.Tensor


def _t(a) -> Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(out: Dict[str, Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _lstm(out: Dict[str, Tensor], prefix: str, layer: int, p: Mapping, sfx: str = "") -> None:
    out[f"{prefix}.weight_ih_l{layer}{sfx}"] = _t(p["w_ih"]).T.contiguous()
    out[f"{prefix}.weight_hh_l{layer}{sfx}"] = _t(p["w_hh"]).T.contiguous()
    out[f"{prefix}.bias_ih_l{layer}{sfx}"] = _t(p["b_ih"])
    out[f"{prefix}.bias_hh_l{layer}{sfx}"] = _t(p["b_hh"])


def _layer_norm(out: Dict[str, Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


# Sub-modules of a transformer block, in the JAX pytree's names.
_ENC_BLOCK = (("ln1", "ln"), ("self_attn", "attn"), ("ln2", "ln"), ("mlp", "mlp"))
_DEC_BLOCK = (("ln1", "ln"), ("self_attn", "attn"), ("ln2", "ln"), ("cross_attn", "attn"),
              ("ln3", "ln"), ("mlp", "mlp"))
_LINEARS = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("fc1", "fc2")}


def _transformer_state_dict(params: Mapping, config: Config) -> Dict[str, Tensor]:
    enc, dec = params["encoder"], params["decoder"]
    m = config.model
    if (len(enc["blocks"]), len(dec["blocks"])) != (m.transformer_num_layers,
                                                   m.transformer_decoder_layers):
        raise ValueError(
            f"parameters hold {len(enc['blocks'])}+{len(dec['blocks'])} transformer blocks, "
            f"the config {m.transformer_num_layers}+{m.transformer_decoder_layers}"
        )
    out: Dict[str, Tensor] = {}

    def blocks(prefix: str, tree: Mapping, layout) -> None:
        for i, blk in enumerate(tree["blocks"]):
            for name, kind in layout:
                sub = f"{prefix}.blocks.{i}.{name}"
                if kind == "ln":
                    _layer_norm(out, sub, blk[name])
                else:
                    for lin in _LINEARS[kind]:
                        _linear(out, f"{sub}.{lin}", blk[name][lin])

    _linear(out, "encoder.feature_projection", enc["feature_projection"])
    out["encoder.pos_embedding"] = _t(enc["pos_embedding"])
    blocks("encoder", enc, _ENC_BLOCK)
    _layer_norm(out, "encoder.ln_f", enc["ln_f"])
    out["decoder.embedding.weight"] = _t(dec["embedding"]["table"])
    out["decoder.pos_embedding"] = _t(dec["pos_embedding"])
    blocks("decoder", dec, _DEC_BLOCK)
    _layer_norm(out, "decoder.ln_f", dec["ln_f"])
    _linear(out, "decoder.output_projection", dec["output_projection"])
    return out


def state_dict_from_jax_params(params: Mapping, config: Config) -> Dict[str, Tensor]:
    """JAX pytree (numpy or jax arrays) -> the port's float32 state_dict."""
    if config.model.architecture == "transformer":
        return _transformer_state_dict(params, config)
    enc, dec = params["encoder"], params["decoder"]
    m = config.model
    if (len(enc["lstm"]), len(dec["lstm"])) != (m.encoder_num_layers, m.decoder_num_layers):
        raise ValueError(
            f"parameters hold {len(enc['lstm'])}+{len(dec['lstm'])} LSTM layers, "
            f"the config {m.encoder_num_layers}+{m.decoder_num_layers}"
        )
    out: Dict[str, Tensor] = {}
    _linear(out, "encoder.feature_projection", enc["feature_projection"])
    for l, layer in enumerate(enc["lstm"]):
        _lstm(out, "encoder.lstm", l, layer["fwd"])
        _lstm(out, "encoder.lstm", l, layer["bwd"], "_reverse")
    _linear(out, "encoder.output_projection", enc["output_projection"])
    out["decoder.embedding.weight"] = _t(dec["embedding"]["table"])
    for l, layer in enumerate(dec["lstm"]):
        _lstm(out, "decoder.lstm", l, layer)
    _linear(out, "decoder.output_projection", dec["output_projection"])
    if "attention" in dec:
        for name, p in dec["attention"].items():
            _linear(out, f"decoder.attention.{name}", p)
        _linear(out, "decoder.context_projection", dec["context_projection"])
    if "init_state_projection" in dec:
        _linear(out, "decoder.init_state_projection", dec["init_state_projection"])
    return out


def _np(t: Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _linear_back(sd: Mapping[str, Tensor], prefix: str) -> dict:
    out = {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"]).copy()
    return out


def _lstm_back(sd: Mapping[str, Tensor], prefix: str, layer: int, sfx: str = "") -> dict:
    def w(name):
        return np.ascontiguousarray(_np(sd[f"{prefix}.{name}_l{layer}{sfx}"]).T)

    def b(name):
        return _np(sd[f"{prefix}.{name}_l{layer}{sfx}"]).copy()

    return {"w_ih": w("weight_ih"), "w_hh": w("weight_hh"),
            "b_ih": b("bias_ih"), "b_hh": b("bias_hh")}


def _layer_norm_back(sd: Mapping[str, Tensor], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]).copy(), "bias": _np(sd[f"{prefix}.bias"]).copy()}


def _transformer_params(sd: Mapping[str, Tensor], config: Config) -> dict:
    m = config.model

    def blocks(prefix: str, n: int, layout) -> list:
        out = []
        for i in range(n):
            blk = {}
            for name, kind in layout:
                sub = f"{prefix}.blocks.{i}.{name}"
                blk[name] = (_layer_norm_back(sd, sub) if kind == "ln" else
                             {lin: _linear_back(sd, f"{sub}.{lin}") for lin in _LINEARS[kind]})
            out.append(blk)
        return out

    encoder = {
        "feature_projection": _linear_back(sd, "encoder.feature_projection"),
        "pos_embedding": _np(sd["encoder.pos_embedding"]).copy(),
        "blocks": blocks("encoder", m.transformer_num_layers, _ENC_BLOCK),
        "ln_f": _layer_norm_back(sd, "encoder.ln_f"),
    }
    decoder = {
        "embedding": {"table": _np(sd["decoder.embedding.weight"]).copy()},
        "pos_embedding": _np(sd["decoder.pos_embedding"]).copy(),
        "blocks": blocks("decoder", m.transformer_decoder_layers, _DEC_BLOCK),
        "ln_f": _layer_norm_back(sd, "decoder.ln_f"),
        "output_projection": _linear_back(sd, "decoder.output_projection"),
    }
    return {"encoder": encoder, "decoder": decoder}


def attention_linears(config: Config) -> tuple:
    """The attention's linears, by the names of the JAX pytree and the
    upstream torch model (video_captioning_tpu/models/torch_port.py)."""
    m = config.model
    if m.attention_type == "bahdanau":
        return ("encoder_projection", "decoder_projection", "attention_linear")
    if m.attention_type == "multihead":
        return ("query_linear", "key_linear", "value_linear", "output_linear")
    if m.attention_type != "luong":
        raise ValueError(f"Unsupported attention type: {m.attention_type}")
    return {"general": ("linear_in",), "concat": ("linear_query", "linear_context", "linear_v"),
            "dot": ()}[m.luong_score]


def jax_params_from_state_dict(state_dict: Mapping[str, Tensor], config: Config) -> dict:
    """The port's state_dict -> the JAX parameter pytree as float32 numpy
    arrays; the exact inverse of :func:`state_dict_from_jax_params`."""
    if config.model.architecture == "transformer":
        return _transformer_params(state_dict, config)
    sd, m = state_dict, config.model
    encoder = {
        "feature_projection": _linear_back(sd, "encoder.feature_projection"),
        "lstm": [{"fwd": _lstm_back(sd, "encoder.lstm", l),
                  "bwd": _lstm_back(sd, "encoder.lstm", l, "_reverse")}
                 for l in range(m.encoder_num_layers)],
        "output_projection": _linear_back(sd, "encoder.output_projection"),
    }
    decoder = {
        "embedding": {"table": _np(sd["decoder.embedding.weight"]).copy()},
        "lstm": [_lstm_back(sd, "decoder.lstm", l) for l in range(m.decoder_num_layers)],
        "output_projection": _linear_back(sd, "decoder.output_projection"),
    }
    if m.use_attention:
        decoder["attention"] = {name: _linear_back(sd, f"decoder.attention.{name}")
                                for name in attention_linears(config)}
        decoder["context_projection"] = _linear_back(sd, "decoder.context_projection")
    if "decoder.init_state_projection.weight" in sd:
        decoder["init_state_projection"] = _linear_back(sd, "decoder.init_state_projection")
    return {"encoder": encoder, "decoder": decoder}


# --------------------------------------------------------------------------
# numpy initializer with init_model's distributions
# --------------------------------------------------------------------------


def _uniform(rng: np.random.Generator, shape, bound: float) -> np.ndarray:
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _orthogonal(rng: np.random.Generator, n_rows: int, n_cols: int) -> np.ndarray:
    big, small = max(n_rows, n_cols), min(n_rows, n_cols)
    q, r = np.linalg.qr(rng.standard_normal((big, small)))
    q = q * np.sign(np.diagonal(r))[None, :]
    return (q.T if n_rows < n_cols else q).astype(np.float32)


def _torch_linear(rng, in_dim: int, out_dim: int) -> dict:
    bound = 1.0 / math.sqrt(in_dim)
    return {"kernel": _uniform(rng, (in_dim, out_dim), bound),
            "bias": _uniform(rng, (out_dim,), bound)}


def _xavier_linear(rng, in_dim: int, out_dim: int) -> dict:
    bound = math.sqrt(6.0 / (in_dim + out_dim))
    return {"kernel": _uniform(rng, (in_dim, out_dim), bound),
            "bias": np.zeros((out_dim,), np.float32)}


def _lstm_torch_default(rng, in_dim: int, hidden: int) -> dict:
    bound = 1.0 / math.sqrt(hidden)
    g4 = 4 * hidden
    return {"w_ih": _uniform(rng, (in_dim, g4), bound),
            "w_hh": _uniform(rng, (hidden, g4), bound),
            "b_ih": _uniform(rng, (g4,), bound),
            "b_hh": _uniform(rng, (g4,), bound)}


def _lstm_orthogonal(rng, in_dim: int, hidden: int) -> dict:
    g4 = 4 * hidden
    return {"w_ih": _orthogonal(rng, g4, in_dim).T.copy(),
            "w_hh": _orthogonal(rng, g4, hidden).T.copy(),
            "b_ih": np.zeros((g4,), np.float32),
            "b_hh": np.zeros((g4,), np.float32)}


def _init_transformer(rng: np.random.Generator, config: Config, vocab_size: int) -> dict:
    """``init_transformer``'s distributions: xavier-uniform attention, MLP
    and vocabulary kernels with zero biases, 0.02 N(0, 1) position tables
    and embedding, layer norms at one and zero, and the feature projection
    as a torch-default linear."""
    m = config.model
    D, ratio = m.decoder_hidden_dim, m.transformer_mlp_ratio
    sizes = {"attn": {n: (D, D) for n in _LINEARS["attn"]},
             "mlp": {"fc1": (D, ratio * D), "fc2": (ratio * D, D)}}

    def normal(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def block(layout) -> dict:
        return {name: ({"scale": np.ones((D,), np.float32), "bias": np.zeros((D,), np.float32)}
                       if kind == "ln" else
                       {lin: _xavier_linear(rng, *sizes[kind][lin]) for lin in _LINEARS[kind]})
                for name, kind in layout}

    ln_f = {"scale": np.ones((D,), np.float32), "bias": np.zeros((D,), np.float32)}
    encoder = {
        "feature_projection": _torch_linear(rng, m.cnn_feature_dim, D),
        "pos_embedding": normal(m.video_sequence_length, D),
        "blocks": [block(_ENC_BLOCK) for _ in range(m.transformer_num_layers)],
        "ln_f": ln_f,
    }
    decoder = {
        "embedding": {"table": normal(vocab_size, D)},
        "pos_embedding": normal(m.max_sequence_length + 1, D),
        "blocks": [block(_DEC_BLOCK) for _ in range(m.transformer_decoder_layers)],
        "ln_f": {k: v.copy() for k, v in ln_f.items()},
        "output_projection": _xavier_linear(rng, D, vocab_size),
    }
    return {"encoder": encoder, "decoder": decoder}


def _init_attention(rng: np.random.Generator, config: Config) -> dict:
    """``init_attention``'s distributions: torch-default linears, without
    bias where the JAX package has none (Luong's ``linear_in`` and
    ``linear_v``)."""
    m = config.model
    E, D, A = m.encoder_hidden_dim, m.decoder_hidden_dim, m.attention_dim
    shapes = {"encoder_projection": (E, A), "decoder_projection": (D, A),
              "attention_linear": (A, 1), "linear_in": (D, E), "linear_query": (D, A),
              "linear_context": (E, A), "linear_v": (A, 1), "query_linear": (D, E),
              "key_linear": (E, E), "value_linear": (E, E), "output_linear": (E, E)}
    if m.attention_type == "luong" and m.luong_score == "dot" and D != E:
        raise ValueError("dot attention requires decoder_dim == encoder_dim")
    out = {}
    for name in attention_linears(config):
        p = _torch_linear(rng, *shapes[name])
        if name in ("linear_in", "linear_v"):
            del p["bias"]
        out[name] = p
    return out


def init_params_numpy(config: Config, vocab_size: int, seed: int = 0) -> dict:
    """JAX-layout parameter pytree of the transformer family, or of the LSTM
    family with any attention type or none, drawn from
    ``np.random.default_rng(seed)``."""
    m = config.model
    rng = np.random.default_rng(seed)
    if m.architecture == "transformer":
        return _init_transformer(rng, config, vocab_size)
    if m.architecture != "lstm":
        raise ValueError(f"Unsupported architecture: {m.architecture}")
    F, E, D = m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim
    emb = m.embedding_dim
    encoder = {
        "feature_projection": _torch_linear(rng, F, E),
        "lstm": [
            {"fwd": _lstm_torch_default(rng, E if l == 0 else 2 * E, E),
             "bwd": _lstm_torch_default(rng, E if l == 0 else 2 * E, E)}
            for l in range(m.encoder_num_layers)
        ],
        "output_projection": _torch_linear(rng, 2 * E, E),
    }
    lstm_in = emb + E if m.use_attention else emb
    decoder = {
        "embedding": {"table": _uniform(rng, (vocab_size, emb), 0.1)},
        "lstm": [_lstm_orthogonal(rng, lstm_in if l == 0 else D, D)
                 for l in range(m.decoder_num_layers)],
        "output_projection": _xavier_linear(rng, D, vocab_size),
    }
    if m.use_attention:
        decoder["attention"] = _init_attention(rng, config)
        decoder["context_projection"] = _xavier_linear(rng, E + D + emb, D)
    if E != D:
        decoder["init_state_projection"] = _torch_linear(rng, E, D)
    return {"encoder": encoder, "decoder": decoder}


# --------------------------------------------------------------------------
# CNN backbones: the JAX pytrees of models/backbones (numpy) <-> torchvision
# state dicts (conv kernels HWIO <-> OIHW, linear (in, out) <-> (out, in),
# BN scale / bias / mean / var <-> weight / bias / running_mean /
# running_var). The inverse gives what the JAX package's load_torch_vgg16 /
# load_torch_resnet50 give for the same state dict.
# --------------------------------------------------------------------------


def _conv_t(kernel) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, np.float32)
                                                 .transpose(3, 2, 0, 1)))


def _bn_names(prefix: str) -> Dict[str, str]:
    return {"scale": f"{prefix}.weight", "bias": f"{prefix}.bias",
            "mean": f"{prefix}.running_mean", "var": f"{prefix}.running_var"}


def _resnet_blocks():
    from .backbones.resnet import BLOCKS_PER_STAGE

    for s, n in enumerate(BLOCKS_PER_STAGE):
        for b in range(n):
            yield s, b, f"layer{s + 1}.{b}"


_RESNET_CONVS = (("conv1", "bn1", "conv1", "bn1"), ("conv2", "bn2", "conv2", "bn2"),
                 ("conv3", "bn3", "conv3", "bn3"),
                 ("downsample_conv", "downsample_bn", "downsample.0", "downsample.1"))


def backbone_state_dict_from_jax(params: Mapping, model_type: str) -> Dict[str, Tensor]:
    """JAX backbone pytree (numpy or jax arrays) -> torchvision-named float32
    state dict of ``VGG16`` / ``ResNet50``."""
    out: Dict[str, Tensor] = {}
    if model_type == "vgg16":
        from .backbones.vgg import conv_feature_indices

        for idx, p in zip(conv_feature_indices(), params["convs"]):
            out[f"features.{idx}.weight"] = _conv_t(p["kernel"])
            out[f"features.{idx}.bias"] = _t(p["bias"])
        _linear(out, "classifier.0", params["fc6"])
        _linear(out, "classifier.3", params["fc7"])
        return out
    if model_type != "resnet50":
        raise ValueError(f"Unsupported model type: {model_type}")

    def conv_bn(conv_name, bn_name, conv, bn):
        out[f"{conv_name}.weight"] = _conv_t(conv["kernel"])
        for key, name in _bn_names(bn_name).items():
            out[name] = _t(bn[key])

    conv_bn("conv1", "bn1", params["conv1"], params["bn1"])
    for s, b, prefix in _resnet_blocks():
        block = params["stages"][s][b]
        for conv, bn, tconv, tbn in _RESNET_CONVS:
            if conv in block:
                conv_bn(f"{prefix}.{tconv}", f"{prefix}.{tbn}", block[conv], block[bn])
    return out


def jax_backbone_params_from_state_dict(state: Mapping, model_type: str) -> dict:
    """torchvision state dict (tensors or numpy) -> the JAX backbone pytree
    as float32 numpy arrays; extra entries (fc8, num_batches_tracked) are
    ignored."""
    def arr(name):
        v = state[name]
        return (v.detach().cpu().float().numpy() if isinstance(v, Tensor)
                else np.asarray(v, np.float32)).copy()

    def conv(name):
        return {"kernel": np.ascontiguousarray(arr(f"{name}.weight").transpose(2, 3, 1, 0))}

    if model_type == "vgg16":
        from .backbones.vgg import conv_feature_indices

        def fc(prefix):
            return {"kernel": np.ascontiguousarray(arr(f"{prefix}.weight").T),
                    "bias": arr(f"{prefix}.bias")}

        return {"convs": [{**conv(f"features.{i}"), "bias": arr(f"features.{i}.bias")}
                          for i in conv_feature_indices()],
                "fc6": fc("classifier.0"), "fc7": fc("classifier.3")}
    if model_type != "resnet50":
        raise ValueError(f"Unsupported model type: {model_type}")

    def bn(name):
        return {key: arr(tname) for key, tname in _bn_names(name).items()}

    params: dict = {"conv1": conv("conv1"), "bn1": bn("bn1"), "stages": []}
    for s, b, prefix in _resnet_blocks():
        if b == 0:
            params["stages"].append([])
        block = {}
        for cname, bname, tconv, tbn in _RESNET_CONVS:
            if f"{prefix}.{tconv}.weight" in state:
                block[cname], block[bname] = conv(f"{prefix}.{tconv}"), bn(f"{prefix}.{tbn}")
        params["stages"][s].append(block)
    return params


def load_backbone_state(model: torch.nn.Module, state: Mapping) -> None:
    """Load a torchvision-named state dict (tensors or numpy arrays) into
    ``VGG16`` / ``ResNet50``, ignoring the entries the extractor has no use
    for (fc8, ``num_batches_tracked``); a missing parameter raises."""
    own = model.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"state dict lacks {len(missing)} backbone entries, e.g. {missing[:3]}")
    model.load_state_dict({k: torch.as_tensor(state[k]) for k in own if k in state},
                          strict=False)


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts and lists (other
    leaves, such as Python floats, are kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, Tensor) else tree


def init_backbone_params_numpy(model_type: str, seed: int = 0) -> dict:
    """JAX-layout backbone pytree from ``np.random.default_rng(seed)``: the
    JAX package's init distributions (torch-default uniform convs and fc
    layers for VGG16; He-normal fan-out convs for ResNet50), with ResNet50's
    BN statistics randomized so that folding is not the identity."""
    rng = np.random.default_rng(seed)
    if model_type == "vgg16":
        from .backbones.vgg import VGG16_PLAN

        def uniform(shape, fan_in):  # float32 draws: fc6 alone is 102.8M values
            return (rng.random(shape, dtype=np.float32) * 2 - 1) / np.float32(math.sqrt(fan_in))

        convs, cin = [], 3
        for item in VGG16_PLAN:
            if item == "M":
                continue
            convs.append({"kernel": uniform((3, 3, cin, item), 9 * cin),
                          "bias": uniform((item,), 9 * cin)})
            cin = item
        return {"convs": convs,
                **{name: {"kernel": uniform((cin_, cout), cin_), "bias": uniform((cout,), cin_)}
                   for name, cin_, cout in (("fc6", 512 * 7 * 7, 4096), ("fc7", 4096, 4096))}}
    if model_type != "resnet50":
        raise ValueError(f"Unsupported model type: {model_type}")
    from .backbones.resnet import BLOCKS_PER_STAGE, EXPANSION, STAGE_WIDTH

    def conv(k, cin, cout):
        std = math.sqrt(2.0 / (k * k * cout))
        return {"kernel": (rng.standard_normal((k, k, cin, cout)) * std).astype(np.float32)}

    def bn(c):
        return {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.05 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    params: dict = {"conv1": conv(7, 3, 64), "bn1": bn(64), "stages": []}
    cin = 64
    for n, width in zip(BLOCKS_PER_STAGE, STAGE_WIDTH):
        blocks = []
        for b in range(n):
            cout = width * EXPANSION
            block = {"conv1": conv(1, cin, width), "bn1": bn(width),
                     "conv2": conv(3, width, width), "bn2": bn(width),
                     "conv3": conv(1, width, cout), "bn3": bn(cout)}
            if b == 0:
                block["downsample_conv"], block["downsample_bn"] = conv(1, cin, cout), bn(cout)
            blocks.append(block)
            cin = cout
        params["stages"].append(blocks)
    return params
