"""W8A8 decode (``decode_int8="vocab"|"full"``) in the port against the JAX
package on the CPU: the weight quantization (``weight_q`` equal entry for
entry, ``w_scale`` within one ulp), the dynamic-activation int8 linear
(within 1e-5 of the output's largest value), ``quantize_decode_params``
through the weight bridge, greedy and beam-5 tokens under the
sharpened-logits protocol of benchmarks/int8_decode_gate.py (sharpen 3.0,
END suppressed; ``all_scores`` within 1e-4), the int8 products a decode
step against the JAX step's, the fused-vocabulary gate, the merged QKV,
and the predictor, BatchPredictor, server and ``cli.serve``."""

import json
import logging
import unittest.mock as mock
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.generation.beam import beam_search_generate as j_beam
from video_captioning_tpu.generation.greedy import greedy_generate as j_greedy
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.models import layers as j_layers
from video_captioning_tpu.models import transformer as j_tr
from video_captioning_tpu.models.quantize import quantize_decode_params as j_quantize
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.cli import serve
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.generation import beam as t_beam
from video_captioning_tpu_torch.generation.beam import beam_search_generate as t_beam_generate
from video_captioning_tpu_torch.generation.families import vocab_projection_info
from video_captioning_tpu_torch.generation.greedy import greedy_generate as t_greedy
from video_captioning_tpu_torch.inference.predictor import BatchPredictor, VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.models import transformer as t_tr
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, encode
from video_captioning_tpu_torch.models.layers import Int8Linear, int8_linear, linear
from video_captioning_tpu_torch.models.layers import quantize_linear_int8
from video_captioning_tpu_torch.models.quantize import LEVELS, quantize_decode_params
from video_captioning_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.ops import launch_counts, reset_launch_counts

START, END = 1, 2
VOCAB = 60
SHARPEN = 3.0
LINEAR_TOL = 1e-5  # of the output's largest value
SCORE_TOL = 1e-4


def _config(arch="lstm"):
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 32, 32
    m.embedding_dim, m.attention_dim, m.attention_num_heads = 32, 32, 4
    m.max_sequence_length, m.video_sequence_length = 8, 10
    m.architecture = arch
    if arch == "transformer":
        m.transformer_num_layers = m.transformer_decoder_layers = 2
        m.transformer_num_heads = 4
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    return cfg


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _params(cfg, seed=0):
    """The JAX tree of int8_decode_gate.py: projection sharpened x3, END
    suppressed."""
    params = jax.tree_util.tree_map(np.array, init_model(jax.random.PRNGKey(seed), cfg, VOCAB))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * SHARPEN
    out["bias"][END] = -1e9
    return params


def _model(cfg, params):
    model = VideoCaptioningModel(_port(cfg), VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, _port(cfg)))
    return model.eval()


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("shape,bias", [((40, 24), True), ((33, 8), False), ((60, 32), True)])
def test_quantize_linear_matches_jax(shape, bias):
    """weight_q equal entry for entry and w_scale within one ulp; any entry
    one int8 step apart is counted and reported."""
    rs = np.random.RandomState(sum(shape))
    kernel = (rs.randn(shape[1], shape[0]) * rs.uniform(0.01, 3, shape[0])).astype(np.float32)
    kernel[:, 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    p = {"kernel": kernel}
    if bias:
        p["bias"] = rs.randn(shape[0]).astype(np.float32)
    want = j_layers.quantize_linear_int8({k: jnp.asarray(v) for k, v in p.items()})
    mod = torch.nn.Linear(shape[1], shape[0], bias=bias)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(kernel.T))
        if bias:
            mod.bias.copy_(torch.from_numpy(p["bias"]))
    got = quantize_linear_int8(mod)
    assert isinstance(got, Int8Linear) and got.weight_q.dtype == torch.int8
    assert (got.out_features, got.in_features) == shape
    wq = np.asarray(want["kernel_q"]).T
    steps = np.abs(got.weight_q.numpy().astype(np.int32) - wq.astype(np.int32))
    print(f"quantize {shape}: {int((steps == 1).sum())} of {steps.size} entries one step apart")
    np.testing.assert_array_equal(got.weight_q.numpy(), wq)
    ulps = np.abs(got.w_scale.numpy().view(np.int32) - np.asarray(want["w_scale"]).view(np.int32))
    assert ulps.max() <= 1
    if bias:
        np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want["bias"]))
    else:
        assert got.bias is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(7,), (3, 5)])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_jax(dtype, lead, bias):
    """2-D and 3-D inputs, with and without bias, float32 and bfloat16
    activations: within 1e-5 of the output's largest value, in x's dtype."""
    rs = np.random.RandomState(len(lead) + 2 * bias)
    mod = torch.nn.Linear(24, 40, bias=bias)
    q = quantize_linear_int8(mod)
    x32 = rs.randn(*lead, 24).astype(np.float32) * 2.0
    x = torch.from_numpy(x32).to(dtype)
    jp = {"kernel_q": jnp.asarray(q.weight_q.numpy().T), "w_scale": jnp.asarray(q.w_scale.numpy())}
    if bias:
        jp["bias"] = jnp.asarray(q.bias.numpy())
    jx = jnp.asarray(x32).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(j_layers.int8_linear(jp, jx).astype(jnp.float32))
    got = int8_linear(q, x)
    assert got.dtype == dtype and got.shape == lead + (40,)
    assert torch.equal(linear(q, x), got) and torch.equal(q(x), got)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    print(f"int8_linear {lead} {dtype} bias={bias}: max err {err:.3g} of the largest value")
    assert err <= LINEAR_TOL


# ------------------------------------------------------------- transform


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
@pytest.mark.parametrize("level", ["vocab", "full"])
def test_quantize_decode_params_matches_jax_tree(arch, level):
    """The port's quantized model, read back through the bridge, equals the
    JAX package's quantized tree leaf for leaf (kernel_q exactly, w_scale
    within one ulp); the bridge also loads the JAX tree into it."""
    cfg = _config(arch)
    params = _params(cfg)
    model = _model(cfg, params)
    qmodel = quantize_decode_params(model, _port(cfg), level)
    assert qmodel is not model and isinstance(model.decoder.output_projection, torch.nn.Linear)
    want = jax.tree_util.tree_map(np.asarray, j_quantize(params, cfg, level))
    got = jax_params_from_state_dict(qmodel.state_dict(), _port(cfg))
    want_leaves, got_leaves = _leaves(want), _leaves(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    n_int8 = 0
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        name = jax.tree_util.keystr(path)
        assert g.dtype == w.dtype, name
        if name.endswith("['w_scale']"):
            assert np.abs(g.view(np.int32) - w.view(np.int32)).max() <= 1, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        n_int8 += name.endswith("['kernel_q']")
    blocks = 2 * 10 if arch == "transformer" and level == "full" else 0
    assert n_int8 == 1 + blocks
    back = _model(cfg, params)
    back = quantize_decode_params(back, _port(cfg), level)
    back.load_state_dict(state_dict_from_jax_params(want, _port(cfg)))
    for k, v in back.state_dict().items():
        assert torch.equal(v, torch.from_numpy(np.ascontiguousarray(
            state_dict_from_jax_params(want, _port(cfg))[k].numpy()))), k
    if arch == "lstm":  # the gate matrices stay float at every level
        assert all(p.dtype == torch.float32 for p in qmodel.decoder.lstm.parameters())
    with pytest.raises(ValueError, match="decode_int8 must be one of"):
        quantize_decode_params(model, _port(cfg), "int4")
    assert quantize_decode_params(model, _port(cfg), "off") is model
    assert LEVELS == ("off", "vocab", "full")


# ---------------------------------------------------------------- tokens


def _encode_both(cfg, params, model, B=6, seed=3):
    rs = np.random.RandomState(seed)
    feats = rs.randn(B, 10, cfg.model.cnn_feature_dim).astype(np.float32)
    feats[1, 7:] = 0.0  # a ragged clip
    with torch.no_grad():
        t_enc = encode(model, _port(cfg), torch.from_numpy(feats))
    j_enc = j_cap.encode(params, cfg, jnp.asarray(feats))
    return t_enc, j_enc


@pytest.mark.parametrize("arch,level", [("lstm", "vocab"), ("transformer", "full")])
@pytest.mark.parametrize("K", [1, 5])
def test_int8_tokens_identical_to_jax(arch, level, K):
    cfg = _config(arch)
    params = _params(cfg)
    qparams = j_quantize(jax.tree_util.tree_map(jnp.asarray, params), cfg, level)
    qmodel = quantize_decode_params(_model(cfg, params), _port(cfg), level)
    (t_enc, t_final, t_mask), (j_enc, j_final, j_mask) = _encode_both(cfg, qparams, qmodel)
    L = cfg.model.max_sequence_length
    with torch.no_grad():
        if K == 1:
            got = t_greedy(qmodel, _port(cfg), t_enc, t_final, START, END, L, t_mask)
        else:
            got = t_beam_generate(qmodel, _port(cfg), t_enc, t_final, START, END, L, t_mask,
                                  beam_size=K)
    if K == 1:
        want = j_greedy(qparams, cfg, j_enc, j_final, START, END, L, j_mask)
    else:
        want = j_beam(qparams, cfg, j_enc, j_final, START, END, L, j_mask, beam_size=K)
    np.testing.assert_array_equal(got["generated_tokens"].numpy(),
                                  np.asarray(want["generated_tokens"]))
    if K > 1:
        np.testing.assert_array_equal(got["all_tokens"].numpy(), np.asarray(want["all_tokens"]))
        np.testing.assert_allclose(got["all_scores"].numpy(), np.asarray(want["all_scores"]),
                                   rtol=0, atol=SCORE_TOL)


# ---------------------------------------------------- gate and merged QKV


def test_fused_vocab_gate_refuses_an_int8_vocabulary():
    """The gate is false for an int8 vocabulary; with the fused path forced
    on the CPU (the gate patched true, as the other tests force it) the
    beam still makes no vocab_topk_lse call, and its tokens equal the
    hierarchical path's."""
    cfg = _config()
    pcfg = _port(cfg)
    pcfg.kernels.use_fused_vocab_topk = True
    cuda = torch.device("cuda")
    assert t_beam.fused_vocab_eligible(pcfg, cuda, 4, 5, VOCAB)
    assert not t_beam.fused_vocab_eligible(pcfg, cuda, 4, 5, VOCAB, vocab_quantized=True)
    params = _params(cfg)
    qmodel = quantize_decode_params(_model(cfg, params), pcfg, "vocab")
    assert vocab_projection_info(qmodel.decoder) == (VOCAB, True)
    assert vocab_projection_info(_model(cfg, params).decoder) == (VOCAB, False)
    with torch.no_grad():
        enc, final, mask = encode(qmodel, pcfg, torch.randn(4, 10, 24))
        plain = t_beam_generate(qmodel, pcfg, enc, final, START, END, 8, mask, beam_size=5)
        reset_launch_counts()
        with mock.patch.object(t_beam, "fused_vocab_eligible", return_value=True), \
                mock.patch.object(t_beam, "vocab_topk_lse", side_effect=AssertionError):
            forced = t_beam_generate(qmodel, pcfg, enc, final, START, END, 8, mask,
                                     beam_size=5)
    assert launch_counts()["vocab_topk_lse"] == 0
    for k in plain:
        assert torch.equal(forced[k], plain[k]), k


def test_merged_qkv_leaves_quantized_blocks_split():
    cfg = _config("transformer")
    model = _model(cfg, _params(cfg))
    merged = t_tr.merge_self_attn_qkv(model.decoder)
    assert all(m is not None for m in merged)
    for level, split in (("vocab", False), ("full", True)):
        q = quantize_decode_params(model, _port(cfg), level)
        assert all((m is None) == split for m in t_tr.merge_self_attn_qkv(q.decoder))
    # JAX leaves them split the same way.
    jq = j_quantize(jax.tree_util.tree_map(jnp.asarray, _params(cfg)), cfg, "full")
    assert all("wqkv" not in b["self_attn"] for b in j_tr.merge_self_attn_qkv(jq["decoder"])["blocks"])


# ---------------------------------------------- predictor, server, CLI


CAPTIONS = ["a man rides a horse", "a dog runs in the park", "a cat sleeps on a bed"]


def _package(directory, cfg):
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    V = len(vocab)
    params = jax.tree_util.tree_map(np.array, init_model(jax.random.PRNGKey(0), cfg, V))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * SHARPEN
    out["bias"][vocab.end_idx] = -1e9
    return CheckpointManager(Path(directory)).save_model_for_inference(params, vocab, cfg)


@pytest.mark.parametrize("arch,level,dtype", [("lstm", "vocab", None), ("lstm", "full", None),
                                              ("transformer", "full", None),
                                              ("lstm", "vocab", "bfloat16")])
def test_predictor_serves_int8_like_jax(tmp_path, caplog, arch, level, dtype):
    """The predictor quantizes after the bfloat16 cast, as the JAX
    predictor does, logs the JAX message, and its greedy and beam tokens
    equal the JAX predictor's; BatchPredictor serves through it."""
    cfg = _config(arch)
    pkg = _package(tmp_path, cfg)
    jp = JaxPredictor(Path(pkg), config=cfg, compute_dtype=dtype, decode_int8=level)
    with caplog.at_level(logging.INFO):
        tp = VideoCaptionPredictor(pkg, config=_port(cfg), device="cpu", compute_dtype=dtype,
                                   decode_int8=level)
    assert any(f"W8A8 (level={level})" in r.getMessage() for r in caplog.records)
    proj = tp.model.decoder.output_projection
    assert isinstance(proj, Int8Linear) and proj.w_scale.dtype == torch.float32
    want_wq = np.asarray(jp.params["decoder"]["output_projection"]["kernel_q"]).T
    np.testing.assert_array_equal(proj.weight_q.numpy(), want_wq)
    if dtype == "bfloat16":
        assert tp.model.decoder.lstm.weight_hh_l0.dtype == torch.bfloat16
    feats = [np.random.RandomState(i).randn(10, 24).astype(np.float32) for i in range(3)]
    for method in ("greedy", "beam"):
        got = tp.predict_batch(feats, method=method, beam_size=5, max_length=8)
        want = jp.predict_batch(feats, method=method, beam_size=5, max_length=8)
        if dtype is None:
            assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want], method
    batch = BatchPredictor(tp, batch_size=2)
    with mock.patch.object(tp, "_extract_video_features",
                           side_effect=lambda p: feats[int(p.stem[1:])]):
        res = batch.predict_videos([f"v{i}.mp4" for i in range(3)], method="beam", beam_size=5)
    assert [r["tokens"] for r in res] == [r["tokens"] for r in tp.predict_batch(
        feats, method="beam", beam_size=5)]


def test_predictor_and_serve_refuse_what_jax_refuses(tmp_path):
    cfg = _config()
    pkg = _package(tmp_path, cfg)
    with pytest.raises(ValueError, match="decode_int8 must be one of"):
        VideoCaptionPredictor(pkg, device="cpu", decode_int8="int4")
    with pytest.raises(ValueError, match="vcx.*decode_int8 applies at model-load time"):
        VideoCaptionPredictor(tmp_path / "m.vcx", decode_int8="vocab")
    for level in ("vocab", "full"):
        with pytest.raises(SystemExit, match="model-load time"):
            serve.main(["--model-path", str(tmp_path / "m.vcx"), "--decode-int8", level])
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--model-path", "m.pth", "--decode-int8", "int4"])


@pytest.mark.parametrize("level", ["vocab", "full"])
def test_serve_cli_hands_decode_int8_to_the_predictor(tmp_path, level):
    cfg = _config()
    pkg = _package(tmp_path, cfg)
    seen = {}

    class Stop(Exception):
        pass

    def fake_server(predictor, **kw):
        seen["proj"] = predictor.model.decoder.output_projection
        raise Stop

    with mock.patch("video_captioning_tpu_torch.inference.server.CaptionServer", fake_server):
        with pytest.raises(Stop):
            serve.main(["--model-path", str(pkg), "--device", "cpu", "--decode-int8", level,
                        "--log-level", "WARNING"])
    assert isinstance(seen["proj"], Int8Linear)


def test_server_serves_an_int8_predictor(tmp_path):
    cfg = _config()
    pkg = _package(tmp_path, cfg)
    tp = VideoCaptionPredictor(pkg, device="cpu", decode_int8="vocab")
    feats = np.random.RandomState(5).randn(10, 24).astype(np.float32)
    want = tp.predict_from_features(feats, method="beam", beam_size=3, max_length=6)
    server = CaptionServer(tp, port=0, max_batch=4, max_wait_ms=5.0)
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
    assert got["tokens"] == want["tokens"]


@pytest.mark.parametrize("arch,level", [("lstm", "vocab"), ("transformer", "vocab"),
                                        ("transformer", "full")])
def test_int8_products_a_step_equal_the_jax_steps(arch, level, monkeypatch):
    """The port's ``torch._int_mm`` calls in a beam decode of L steps are
    a * L + b: a = 1 at ``vocab``, 1 + 8 a block at ``full`` (q, k, v left
    split, o, the cross-attention's q and o, the MLP's two linears), b = 2 a
    block at ``full`` (the cross-attention's k and v, once). The JAX
    package's beam search, traced once (its loop body once), calls
    ``int8_linear`` a + b times."""
    cfg = _config(arch)
    params = _params(cfg)
    qmodel = quantize_decode_params(_model(cfg, params), _port(cfg), level)
    blocks = cfg.model.transformer_decoder_layers if arch == "transformer" else 0
    a, b = (1 + 8 * blocks, 2 * blocks) if level == "full" else (1, 0)
    real = torch._int_mm
    calls = []
    monkeypatch.setattr(torch, "_int_mm", lambda x, w: calls.append(1) or real(x, w))
    with torch.no_grad():
        enc, final, mask = encode(qmodel, _port(cfg), torch.randn(2, 10, 24))
        for L in (3, 7):
            calls.clear()
            t_beam_generate(qmodel, _port(cfg), enc, final, START, END, L, mask, beam_size=5)
            assert len(calls) == a * L + b, (L, len(calls))
    monkeypatch.undo()
    jcalls = []
    real_j = j_layers.int8_linear
    monkeypatch.setattr(j_layers, "int8_linear", lambda p, x: jcalls.append(1) or real_j(p, x))
    qparams = j_quantize(jax.tree_util.tree_map(jnp.asarray, params), cfg, level)

    def decode(feats):
        e, f, m = j_cap.encode(qparams, cfg, feats)
        return j_beam(qparams, cfg, e, f, START, END, 7, m, beam_size=5)["generated_tokens"]

    jax.make_jaxpr(decode)(jnp.zeros((2, 10, 24), jnp.float32))
    assert len(jcalls) == a + b
