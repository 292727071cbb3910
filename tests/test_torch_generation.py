"""Greedy and beam generation of the port against the JAX package on the
same weights and inputs: tokens identical, scores to float32 rounding; and
the fixed-seed Bahdanau goldens reproduced through the weight bridge."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu import generation as j_gen
from video_captioning_tpu.config import Config
from video_captioning_tpu.models import init_model
from video_captioning_tpu_torch import generation as t_gen
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, encode
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params

VOCAB = 31


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _pair(cfg, seed, sharpen=3.0):
    """Same weights on both sides; the vocabulary projection sharpened as in
    benchmarks/bf16_parity_gate.py, so random-init logits have trained-model
    margins instead of float32-rounding near-ties."""
    params = init_model(jax.random.PRNGKey(seed), cfg, VOCAB)
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * sharpen
    pcfg = port(cfg)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return params, model.eval()


def _inputs(cfg, seed, B=6, ragged=True):
    rs = np.random.RandomState(seed)
    T = cfg.model.video_sequence_length
    feats = rs.randn(B, T, cfg.model.cnn_feature_dim).astype(np.float32)
    if not ragged:
        return feats, None
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    return feats, (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


def _both(cfg, params, model, feats, mask, method, **kw):
    want = j_gen.generate(params, cfg, jnp.asarray(feats), 1, 2, 8,
                          None if mask is None else jnp.asarray(mask), method=method, **kw)
    with torch.no_grad():
        got = t_gen.generate(model, port(cfg), torch.from_numpy(feats), 1, 2, 8,
                             None if mask is None else torch.from_numpy(mask),
                             method=method, **kw)
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_tokens_identical(tiny_config, interpret, seed):
    cfg = tiny_config
    cfg.kernels.interpret = interpret
    params, model = _pair(cfg, seed)
    feats, mask = _inputs(cfg, seed)
    want, got = _both(cfg, params, model, feats, mask, "greedy")
    np.testing.assert_array_equal(got["generated_tokens"], want["generated_tokens"])
    np.testing.assert_allclose(got["attention_weights"], want["attention_weights"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_topk_kernel", [True, False])
@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_tokens_identical(tiny_config, interpret, use_topk_kernel, seed):
    cfg = tiny_config
    cfg.kernels.interpret = interpret
    cfg.kernels.use_pallas_topk = use_topk_kernel
    params, model = _pair(cfg, seed)
    feats, mask = _inputs(cfg, seed, ragged=seed != 2)
    want, got = _both(cfg, params, model, feats, mask, "beam", beam_size=4)
    for key in ("generated_tokens", "all_tokens"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # -1e9 padding compares exactly; real scores to float32 rounding.
    np.testing.assert_allclose(got["all_scores"], want["all_scores"], rtol=0, atol=1e-4)


def _with_end_bias(cfg, seed, end_bias):
    params, model = _pair(cfg, seed)
    out = params["decoder"]["output_projection"]
    out["bias"] = out["bias"].at[2].set(end_bias)
    with torch.no_grad():
        model.decoder.output_projection.bias[2] = end_bias
    return params, model


@pytest.mark.parametrize("end_bias", [60.0, 3.0])
def test_greedy_stops_when_every_row_ended(tiny_config, end_bias):
    """The batch-wide stop: once every row has emitted END the JAX loop
    ends and the remaining positions stay PAD (0)."""
    cfg = tiny_config
    params, model = _with_end_bias(cfg, 6, end_bias)
    feats, mask = _inputs(cfg, 6)
    want, got = _both(cfg, params, model, feats, mask, "greedy")
    np.testing.assert_array_equal(got["generated_tokens"], want["generated_tokens"])
    if end_bias > 10:
        assert (want["generated_tokens"][:, 1:] == 0).all()


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("end_bias", [4.0, -1e9])
def test_beam_register_and_live_fallback_match(tiny_config, end_bias, beam_size):
    """END favoured: completions fill the register (at K=1 the last live
    beam dies and the batch-wide stop ends the loop); END suppressed:
    nothing completes and every clip falls back to its best live beam."""
    cfg = tiny_config
    params, model = _with_end_bias(cfg, 5, end_bias)
    feats, mask = _inputs(cfg, 5)
    want, got = _both(cfg, params, model, feats, mask, "beam", beam_size=beam_size)
    for key in ("generated_tokens", "all_tokens"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["all_scores"], want["all_scores"], rtol=0, atol=1e-4)


GOLDEN = json.loads(
    (Path(__file__).parent / "golden" / "generation_goldens.json").read_text())


def test_bahdanau_goldens_through_the_bridge():
    """tests/test_goldens.py's setup, decoded by the port."""
    want = GOLDEN["bahdanau"]
    cfg = Config()
    cfg.model.cnn_feature_dim = 24
    cfg.model.encoder_hidden_dim = 16
    cfg.model.decoder_hidden_dim = 16
    cfg.model.embedding_dim = 12
    cfg.model.attention_dim = 16
    cfg.model.attention_type = "bahdanau"
    cfg.model.attention_num_heads = 4
    cfg.data.max_vocab_size = 29
    cfg.validate()
    params = init_model(jax.random.PRNGKey(42), cfg, 29)
    cfg = port(cfg)
    model = VideoCaptioningModel(cfg, 29)
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    feats = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(7), (3, 10, 24))))
    with torch.no_grad():
        enc, final, mask = encode(model.eval(), cfg, feats)
        assert abs(round(float(final.abs().sum()), 4) - want["encoder_final_checksum"]) < 2e-3
        g = t_gen.greedy_generate(model, cfg, enc, final, 1, 2, 10, mask)
        b = t_gen.beam_search_generate(model, cfg, enc, final, 1, 2, 10, mask, beam_size=4)
    np.testing.assert_array_equal(g["generated_tokens"].numpy(), want["greedy"])
    np.testing.assert_array_equal(b["generated_tokens"].numpy(), want["beam_best"])
    np.testing.assert_allclose(b["all_scores"].numpy(), np.asarray(want["beam_scores"]),
                               rtol=1e-3, atol=1e-3)
