"""The transformer family's serving path in the port on the CPU: greedy
and beam generation against the JAX package on the same weights and
encoder outputs, in every beam flag combination the port serves (lazy and
physical rebeam, the fused beam attention and the cross-attention alone,
bfloat16 caches, the fused vocabulary branch), the weight bridge and
``init_params_numpy``, and a package written by the JAX package served by
the port's predictor and HTTP server."""

import json
import unittest.mock as mock
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import video_captioning_tpu.generation.beam as j_beam
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.generation.greedy import greedy_generate as j_greedy
from video_captioning_tpu.inference import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.ops import vocab_topk_pallas as j_vtp
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.generation import beam as t_beam
from video_captioning_tpu_torch.generation.greedy import greedy_generate as t_greedy
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.models import transformer as t_tr
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import (
    init_params_numpy,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.ops import launch_counts, reset_launch_counts

START, END = 1, 2
VOCAB = 32


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


@pytest.fixture
def tr_config(tiny_config):
    """tests/test_transformer.py's small transformer: D 16, 4 heads, 2 + 2
    blocks, V 32, S 10."""
    cfg = tiny_config
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim = cfg.model.decoder_hidden_dim
    cfg.model.transformer_num_layers = 2
    cfg.model.transformer_decoder_layers = 2
    cfg.model.transformer_num_heads = 4
    cfg.validate()
    return cfg


def _setup(cfg, B=3, seed=0):
    """JAX parameters and the port's model on them, and the JAX encoder's
    outputs for ragged clips (both decoders start from the same ones)."""
    params = init_model(jax.random.PRNGKey(seed), cfg, VOCAB)
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * 3.0  # trained-model logit margins
    model = VideoCaptioningModel(port(cfg), VOCAB)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port(cfg)))
    rs = np.random.RandomState(seed + 1)
    feats = rs.randn(B, 10, cfg.model.cnn_feature_dim).astype(np.float32)
    mask = np.ones((B, 10), np.float32)
    mask[1, 6:] = 0.0
    enc, final, jmask = j_cap.encode(params, cfg, jnp.asarray(feats), jnp.asarray(mask))
    torch_in = tuple(_t(np.asarray(x)) for x in (enc, final, jmask))
    return params, model.eval(), (enc, final, jmask), torch_in


def test_greedy_matches_jax(tr_config):
    params, model, (enc, final, jmask), (te, tf, tm) = _setup(tr_config, seed=0)
    want = j_greedy(params, tr_config, enc, final, START, END, 8, jmask)
    with torch.no_grad():
        got = t_greedy(model, port(tr_config), te, tf, START, END, 8, tm)
    np.testing.assert_array_equal(got["generated_tokens"].numpy(),
                                  np.asarray(want["generated_tokens"]))
    np.testing.assert_allclose(got["attention_weights"].numpy(),
                               np.asarray(want["attention_weights"]), rtol=0, atol=2e-5)


BEAM_CASES = {
    "k1": (1, {}),
    "k2_lazy": (2, {}),
    "k2_physical": (2, {"transformer_lazy_rebeam": False}),
    "k5_lazy": (5, {}),
    "k5_physical": (5, {"transformer_lazy_rebeam": False}),
    "k5_split_qkv": (5, {"transformer_merge_qkv": False}),
    "k2_fused": (2, {"transformer_fused_beam_attn": True}),
    "k5_fused": (5, {"transformer_fused_beam_attn": True}),
    "k5_fused_cross_only": (5, {"transformer_fused_cross_attn": True}),
    "k5_cache_bf16": (5, {"transformer_cache_bf16": True}),
    "k5_fused_cache_bf16": (5, {"transformer_fused_beam_attn": True,
                                "transformer_cache_bf16": True}),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_matches_jax(tr_config, case):
    """Tokens, the completed register and its scores; the JAX package runs
    its Pallas kernels in interpret mode where the flags ask for them, the
    port their plain versions."""
    K, flags = BEAM_CASES[case]
    for name, value in flags.items():
        setattr(tr_config.kernels, name, value)
    tr_config.kernels.interpret = True
    params, model, (enc, final, jmask), (te, tf, tm) = _setup(tr_config, seed=K)
    want = j_beam.beam_search_generate(params, tr_config, enc, final, START, END, 6, jmask,
                                       beam_size=K, length_penalty=0.8)
    calls = {"self": 0, "cross": 0}

    def spy(name, fn):
        return lambda *a: calls.__setitem__(name, calls[name] + 1) or fn(*a)

    reset_launch_counts()
    with mock.patch.object(t_tr, "beam_self_attention",
                           spy("self", t_tr.beam_self_attention)), \
         mock.patch.object(t_tr, "beam_cross_attention",
                           spy("cross", t_tr.beam_cross_attention)), \
         torch.no_grad():
        got = t_beam.beam_search_generate(model, port(tr_config), te, tf, START, END, 6, tm,
                                          beam_size=K, length_penalty=0.8)
    assert not any(launch_counts().values())  # CPU tensors: plain versions only
    # Each flag routes the beam step's attention through its wrapper once
    # per decoder block per step (lazy rebeam, K >= 2, as in the JAX package).
    per_call = 2 * 6
    fused = flags.get("transformer_fused_beam_attn", False)
    assert calls == {"self": per_call * fused,
                     "cross": per_call * (fused or "transformer_fused_cross_attn" in flags)}
    for key in ("generated_tokens", "all_tokens"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["all_scores"].numpy(), np.asarray(want["all_scores"]),
                               rtol=0, atol=1e-4)


def test_beam_fused_vocab_matches_jax(tr_config):
    """Both packages forced onto the fused vocabulary branch, which reads
    the transformer's pre-vocab state (step_beam_core): the JAX one as
    tests/test_transformer.py:446 does, the port by patching its gate."""
    tr_config.kernels.use_fused_vocab_topk = True
    tr_config.kernels.transformer_fused_beam_attn = True
    tr_config.kernels.interpret = True
    params, model, (enc, final, jmask), (te, tf, tm) = _setup(tr_config, seed=11)
    orig = j_vtp.vocab_topk_lse
    with mock.patch.object(jax, "default_backend", return_value="tpu"), \
         mock.patch.object(j_vtp, "vocab_topk_lse",
                           lambda *a, **kw: orig(*a, **{**kw, "interpret": True})):
        want = j_beam.beam_search_generate(params, tr_config, enc, final, START, END, 6, jmask,
                                           beam_size=4)
    with mock.patch.object(t_beam, "fused_vocab_eligible", return_value=True), \
         torch.no_grad():
        got = t_beam.beam_search_generate(model, port(tr_config), te, tf, START, END, 6, tm,
                                          beam_size=4)
    for key in ("generated_tokens", "all_tokens"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["all_scores"].numpy(), np.asarray(want["all_scores"]),
                               rtol=0, atol=1e-4)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_bridge_round_trip_is_exact(tr_config):
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(4), tr_config,
                                                           VOCAB))
    cfg = port(tr_config)
    sd = state_dict_from_jax_params(params, cfg)
    model = VideoCaptioningModel(cfg, VOCAB)
    model.load_state_dict(sd)  # strict: names and shapes match the modules
    assert "decoder.blocks.1.cross_attn.wv.weight" in sd and "encoder.ln_f.weight" in sd
    back = jax_params_from_state_dict(model.state_dict(), cfg)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(params)]
    for (path, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_init_params_numpy_matches_init_transformer(tr_config):
    ours = init_params_numpy(port(tr_config), VOCAB, seed=0)
    ref = init_model(jax.random.PRNGKey(0), tr_config, VOCAB)
    want = [(p, np.asarray(x).shape, np.asarray(x).dtype) for p, x in _leaves(ref)]
    got = [(p, x.shape, x.dtype) for p, x in _leaves(ours)]
    assert got == want
    dec = ours["decoder"]
    blk = dec["blocks"][0]
    assert (blk["ln1"]["scale"] == 1).all() and not blk["ln3"]["bias"].any()
    assert not blk["cross_attn"]["wo"]["bias"].any() and not dec["output_projection"]["bias"].any()
    D = tr_config.model.decoder_hidden_dim
    assert np.abs(blk["mlp"]["fc1"]["kernel"]).max() <= np.sqrt(6.0 / (D + 4 * D))
    assert 0.01 < dec["embedding"]["table"].std() < 0.03
    assert ours["encoder"]["feature_projection"]["bias"].any()  # torch-default linear
    cfg = port(tr_config)
    VideoCaptioningModel(cfg, VOCAB).load_state_dict(state_dict_from_jax_params(ours, cfg))


@pytest.fixture(scope="module")
def jax_package(tmp_path_factory):
    """A transformer inference package written by the JAX package."""
    from video_captioning_tpu.config import Config

    tmp = tmp_path_factory.mktemp("transformer_pkg")
    cfg = Config()
    m = cfg.model
    m.architecture = "transformer"
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 16, 16
    m.embedding_dim, m.transformer_num_heads = 16, 4
    m.video_sequence_length = 10
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast",
                            "two cats sleep on a red sofa"])
    params = init_model(jax.random.PRNGKey(5), cfg, len(vocab))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * 3.0
    return CheckpointManager(tmp).save_model_for_inference(params, vocab, cfg)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_predictor_serves_a_jax_written_package(jax_package, method):
    feats = [np.random.RandomState(i).randn(7 + i, 24).astype(np.float32) for i in range(3)]
    want = JaxPredictor(jax_package).predict_batch(feats, method=method, beam_size=3,
                                                   max_length=6)
    pred = VideoCaptionPredictor(jax_package, device="cpu")
    assert isinstance(pred.model.decoder.output_projection, torch.nn.Linear)
    got = pred.predict_batch(feats, method=method, beam_size=3, max_length=6)
    assert [r["tokens"] for r in got] == [list(np.asarray(r["tokens"])) for r in want]
    assert [r["caption"] for r in got] == [r["caption"] for r in want]


def test_caption_server_answers_with_a_transformer_package(jax_package):
    feats = np.random.RandomState(0).randn(7, 24).astype(np.float32)
    want = JaxPredictor(jax_package).predict_from_features(feats, method="beam", beam_size=3,
                                                           max_length=6)
    server = CaptionServer(VideoCaptionPredictor(jax_package, device="cpu"), port=0,
                           max_batch=4, max_wait_ms=10.0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/caption",
            data=json.dumps({"features": feats.tolist(), "method": "beam", "beam_size": 3,
                             "max_length": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = json.loads(resp.read())
    finally:
        server.close()
    assert got["tokens"] == np.asarray(want["tokens"]).tolist()
    assert got["caption"] == want["caption"]
