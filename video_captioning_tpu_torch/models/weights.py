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


def state_dict_from_jax_params(params: Mapping, config: Config) -> Dict[str, Tensor]:
    """JAX pytree (numpy or jax arrays) -> the port's float32 state_dict."""
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


def jax_params_from_state_dict(state_dict: Mapping[str, Tensor], config: Config) -> dict:
    """The port's state_dict -> the JAX parameter pytree as float32 numpy
    arrays; the exact inverse of :func:`state_dict_from_jax_params`."""
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
    if "decoder.context_projection.weight" in sd:
        decoder["attention"] = {
            name: _linear_back(sd, f"decoder.attention.{name}")
            for name in ("encoder_projection", "decoder_projection", "attention_linear")
        }
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


def init_params_numpy(config: Config, vocab_size: int, seed: int = 0) -> dict:
    """JAX-layout parameter pytree of the LSTM family with Bahdanau
    attention, drawn from ``np.random.default_rng(seed)``."""
    m = config.model
    if m.architecture != "lstm" or m.attention_type != "bahdanau" or not m.use_attention:
        raise NotImplementedError("init_params_numpy covers the LSTM family with Bahdanau attention")
    rng = np.random.default_rng(seed)
    F, E, D = m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim
    A, emb = m.attention_dim, m.embedding_dim
    encoder = {
        "feature_projection": _torch_linear(rng, F, E),
        "lstm": [
            {"fwd": _lstm_torch_default(rng, E if l == 0 else 2 * E, E),
             "bwd": _lstm_torch_default(rng, E if l == 0 else 2 * E, E)}
            for l in range(m.encoder_num_layers)
        ],
        "output_projection": _torch_linear(rng, 2 * E, E),
    }
    decoder = {
        "embedding": {"table": _uniform(rng, (vocab_size, emb), 0.1)},
        "lstm": [_lstm_orthogonal(rng, emb + E if l == 0 else D, D)
                 for l in range(m.decoder_num_layers)],
        "output_projection": _xavier_linear(rng, D, vocab_size),
        "attention": {
            "encoder_projection": _torch_linear(rng, E, A),
            "decoder_projection": _torch_linear(rng, D, A),
            "attention_linear": _torch_linear(rng, A, 1),
        },
        "context_projection": _xavier_linear(rng, E + D + emb, D),
    }
    if E != D:
        decoder["init_state_projection"] = _torch_linear(rng, E, D)
    return {"encoder": encoder, "decoder": decoder}
