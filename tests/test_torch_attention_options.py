"""The LSTM decoder's other options in the port against the JAX package on
the same weights (through the bridge) and the same numpy inputs: Luong
attention (dot, general, concat), multi-head attention and the decoder
without attention. Attention modules and decode steps within 2e-5,
teacher forcing's loss within 1e-5 relative and every gradient within
1e-4 of its largest value (dropout off, and with the same masks handed to
both packages), greedy and beam tokens identical with the kernel flags off
and with the fused decode-step flags, Bahdanau's bfloat16 scores, and
``cli.import_reference --attention-type luong|multihead``."""

import json
import pickle
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu import generation as j_gen
from video_captioning_tpu.cli import import_reference as j_ir
from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.models import attention as j_attn
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import decoder as j_dec
from video_captioning_tpu.models import encoder as j_enc
from video_captioning_tpu.models import init_model
from video_captioning_tpu.ops import vocab_topk_pallas as j_vtp
from video_captioning_tpu.training.losses import label_smoothed_cross_entropy as j_loss
from video_captioning_tpu_torch import generation as t_gen
from video_captioning_tpu_torch.cli import import_reference as t_ir
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.generation import beam as t_beam
from video_captioning_tpu_torch.models import attention as t_attn
from video_captioning_tpu_torch.models import decoder as t_dec
from video_captioning_tpu_torch.models import layers as t_layers
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model
from video_captioning_tpu_torch.models.weights import (
    init_params_numpy,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy

VOCAB = 23
ATOL = 2e-5  # float32 on both sides, sum order differs
OPTIONS = {"luong_dot": ("luong", "dot", True), "luong_general": ("luong", "general", True),
           "luong_concat": ("luong", "concat", True), "multihead": ("multihead", "general", True),
           "no_attention": ("bahdanau", "general", False)}
ATTENTION_OPTIONS = [o for o in OPTIONS if OPTIONS[o][2]]
FUSED_FLAGS = ("use_pallas_attention", "use_pallas_lstm", "use_fused_vocab_topk")


def port(cfg) -> PortConfig:
    return PortConfig.from_dict(cfg.to_dict())


def _cfg(tiny_config, option):
    cfg = tiny_config
    cfg.model.attention_type, cfg.model.luong_score, cfg.model.use_attention = OPTIONS[option]
    cfg.model.encoder_num_layers = 1  # the decoder keeps 2 layers (inter-layer dropout)
    cfg.validate()
    return cfg


def _pair(cfg, seed=0, sharpen=3.0):
    """Same weights on both sides, the vocabulary projection sharpened as in
    benchmarks/bf16_parity_gate.py so that beams separate."""
    params = jax.tree_util.tree_map(np.asarray,
                                    init_model(jax.random.PRNGKey(seed), cfg, VOCAB))
    params["decoder"]["output_projection"]["kernel"] = (
        params["decoder"]["output_projection"]["kernel"] * sharpen)
    pcfg = port(cfg)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return params, model.eval()


def _mask(B, T, rs):
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


def _close(got, want, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("init", ["bridge", "numpy"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_bridge_and_numpy_init_cover_every_option(tiny_config, option, init):
    """state_dict_from_jax_params and its inverse are exact, and
    init_params_numpy gives the JAX init's tree (names and shapes)."""
    cfg = _cfg(tiny_config, option)
    want = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(1), cfg, VOCAB))
    params = want if init == "bridge" else init_params_numpy(port(cfg), VOCAB, seed=1)
    sd = state_dict_from_jax_params(params, port(cfg))
    VideoCaptioningModel(port(cfg), VOCAB).load_state_dict(sd)  # strict
    back = jax_params_from_state_dict(sd, port(cfg))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_w]
    for (path, w), (_, b) in zip(flat_w, flat_b):
        assert b.shape == w.shape, path
    if init == "bridge":
        for (path, w), (_, b) in zip(flat_w, flat_b):
            np.testing.assert_array_equal(b, w, err_msg=str(path))


@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("option", ATTENTION_OPTIONS)
def test_attention_matches_jax(tiny_config, option, beam):
    cfg = _cfg(tiny_config, option)
    params, model = _pair(cfg, seed=2)
    rs = np.random.RandomState(2)
    B, S, K = 4, 10, 3
    enc = rs.randn(B, S, cfg.model.encoder_hidden_dim).astype(np.float32)
    hid = rs.randn(*((B, K) if beam else (B,)), cfg.model.decoder_hidden_dim).astype(np.float32)
    mask = _mask(B, S, rs)
    jp = params["decoder"]["attention"]
    jcache = j_attn.precompute(cfg, jp, jnp.asarray(enc))
    jfn = j_attn.attend_beam if beam else j_attn.attend
    want_ctx, want_w = jfn(cfg, jp, jcache, jnp.asarray(enc), jnp.asarray(hid), jnp.asarray(mask))
    attn = model.decoder.attention
    with torch.no_grad():
        tcache = t_attn.precompute(attn, torch.from_numpy(enc))
        fn = t_attn.attend_beam if beam else t_attn.attend
        got_ctx, got_w = fn(port(cfg), attn, tcache, torch.from_numpy(enc),
                            torch.from_numpy(hid), torch.from_numpy(mask))
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        _close(tcache[name], jcache[name])
    _close(got_ctx, want_ctx)
    _close(got_w, want_w)


@pytest.mark.parametrize("beam", [False, True])
def test_attention_score_bf16_matches_jax(tiny_config, beam):
    """kernels.attention_score_bf16 (Bahdanau): tanh in bfloat16 on both
    sides, the score reduction in float32; within bfloat16 rounding of the
    JAX values and away from the float32 ones."""
    cfg = tiny_config
    cfg.kernels.attention_score_bf16 = True
    params, model = _pair(cfg, seed=3)
    rs = np.random.RandomState(3)
    enc = rs.randn(4, 10, 16).astype(np.float32)
    hid = rs.randn(*((4, 3) if beam else (4,)), 16).astype(np.float32)
    mask = _mask(4, 10, rs)
    jp = params["decoder"]["attention"]
    jcache = j_attn.precompute(cfg, jp, jnp.asarray(enc))
    jfn = j_attn.attend_beam if beam else j_attn.attend
    want_ctx, want_w = jfn(cfg, jp, jcache, jnp.asarray(enc), jnp.asarray(hid), jnp.asarray(mask))
    attn = model.decoder.attention
    fn = t_attn.attend_beam if beam else t_attn.attend
    with torch.no_grad():
        tcache = t_attn.precompute(attn, torch.from_numpy(enc))
        args = (attn, tcache, torch.from_numpy(enc), torch.from_numpy(hid),
                torch.from_numpy(mask))
        got_ctx, got_w = fn(port(cfg), *args)
        cfg.kernels.attention_score_bf16 = False
        f32_ctx, f32_w = fn(port(cfg), *args)
    for got, want in ((got_ctx, want_ctx), (got_w, want_w)):
        _close(got, want, 2e-2 * float(np.abs(np.asarray(want)).max()))
    assert float((got_w - f32_w).abs().max()) > 1e-6  # the flag is read


@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_decoder_steps_match_jax(tiny_config, option, beam):
    cfg = _cfg(tiny_config, option)
    params, model = _pair(cfg, seed=4)
    rs = np.random.RandomState(4)
    B, S, K = 4, 10, 3 if beam else 1
    enc = rs.randn(B, S, 16).astype(np.float32)
    mask = _mask(B, S, rs)
    final = rs.randn(B, 16).astype(np.float32)
    tokens = rs.randint(0, VOCAB, size=(B, K) if beam else (B,))
    dp, dec = params["decoder"], model.decoder
    enc_j, mask_j = jnp.asarray(enc), jnp.asarray(mask)
    cache_j = (j_attn.precompute(cfg, dp["attention"], enc_j) if cfg.model.use_attention
               else {})
    state_j = j_dec.init_hidden_state(dp, cfg, jnp.repeat(jnp.asarray(final), K, axis=0))
    with torch.no_grad():
        enc_t, mask_t = torch.from_numpy(enc), torch.from_numpy(mask)
        cache_t = t_dec.precompute_attention(dec, enc_t)
        state_t = t_dec.init_hidden_state(
            dec, port(cfg), torch.from_numpy(final).repeat_interleave(K, dim=0))
        for step in range(3):
            tok = (tokens + step) % VOCAB
            jfn, tfn = ((j_dec.decoder_step_beam, t_dec.decoder_step_beam) if beam
                        else (j_dec.decoder_step, t_dec.decoder_step))
            want_logits, state_j, want_w = jfn(dp, cfg, jnp.asarray(tok, jnp.int32), state_j,
                                               enc_j, cache_j, mask_j)
            got_logits, state_t, got_w = tfn(dec, port(cfg), torch.from_numpy(tok), state_t,
                                             enc_t, cache_t, mask_t)
            _close(got_logits, want_logits)
            _close(state_t[0], state_j[0])
            _close(state_t[1], state_j[1])
            if want_w is None:
                assert got_w is None
            else:
                _close(got_w, want_w)


def _assert_trees_close(got, want, rel):
    """Each leaf within ``rel`` of that leaf's largest value, floored at
    1e-3 of the largest value anywhere."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_w)
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=rel * scale,
                                   err_msg=jax.tree_util.keystr(path))


def _fixed_mask(shape, rate):
    """The keep mask both packages get for a dropout site of this shape."""
    rs = np.random.RandomState(sum(shape) * 31 + len(shape))
    return rs.rand(*shape) >= rate


@pytest.mark.parametrize("dropout", ["off", "masks"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_teacher_forcing_loss_and_grads_match_jax(tiny_config, monkeypatch, option, dropout):
    """Logits, the label-smoothed loss and every gradient against
    jax.value_and_grad. ``masks``: dropout on at every site of both
    packages (encoder, embeddings, between decoder layers, the attention
    weights of each type) with the same keep masks handed in, and
    ``training.remat_attention`` on."""
    cfg = _cfg(tiny_config, option)
    cfg.training.remat_attention = dropout == "masks"
    params, model = _pair(cfg, seed=5, sharpen=1.0)
    pcfg = port(cfg)
    rs = np.random.RandomState(5)
    feats = rs.randn(3, 10, 24).astype(np.float32)
    inp = rs.randint(0, VOCAB, (3, 8)).astype(np.int32)
    tgt = rs.randint(1, VOCAB, (3, 8)).astype(np.int32)
    tgt[0, 5:] = 0
    rng, generator = None, None
    if dropout == "masks":
        seen = {"jax": [], "port": []}

        def j_dropout(x, rate, rng, train):
            if not train or rate <= 0.0 or rng is None:
                return x
            seen["jax"].append(tuple(x.shape))
            return jnp.where(_fixed_mask(x.shape, rate), x / (1.0 - rate), 0.0)

        def t_mask(shape, rate, gen, device):
            if gen is None or rate <= 0.0:
                return None
            seen["port"].append(tuple(shape))
            return torch.from_numpy(_fixed_mask(tuple(shape), rate)).float() / (1.0 - rate)

        for mod in (j_enc, j_dec, j_attn):
            monkeypatch.setattr(mod, "dropout", j_dropout)
        for mod in (t_layers, t_dec, t_attn):
            monkeypatch.setattr(mod, "dropout_mask", t_mask)
        rng, generator = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)

    def j_loss_fn(p):
        out = j_cap.apply_model(p, cfg, jnp.asarray(feats), jnp.asarray(inp), train=True, rng=rng)
        return j_loss(out["logits"], jnp.asarray(tgt), 0, 0.1), out["logits"]

    (want_loss, want_logits), want = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(params)
    out = apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp), train=True,
                      generator=generator)
    loss = label_smoothed_cross_entropy(out["logits"], torch.from_numpy(tgt), 0, 0.1)
    loss.backward()
    if dropout == "masks":  # every JAX site has its counterpart, by shape
        assert sorted(set(seen["port"])) == sorted(set(seen["jax"]))
        attn_shape = (3, 4, 10) if option == "multihead" else (3, 10)
        assert (attn_shape in seen["port"]) == cfg.model.use_attention
    assert (out["attention_weights"] is None) == (not cfg.model.use_attention)
    _close(out["logits"], want_logits, 1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = jax_params_from_state_dict({k: p.grad for k, p in model.named_parameters()}, pcfg)
    _assert_trees_close(got, want, 1e-4)


def _generate_both(cfg, params, model, feats, mask, method, **kw):
    """Flags off: encode and decode on each side. Fused flags: the JAX
    encoder's outputs feed both decoders (as in
    tests/test_torch_decode_kernels.py), since the fused vocabulary
    projection rounds the pre-vocab state to bfloat16 and the encoders'
    bfloat16 recurrence contract lets float32 rounding differences through
    to it; the JAX package is forced onto its fused vocabulary path."""
    fused = cfg.kernels.use_fused_vocab_topk
    if not fused:
        fn = jax.jit(lambda p, f, m: j_gen.generate(p, cfg, f, 1, 2, 8, m, method=method, **kw))
        want = fn(params, jnp.asarray(feats), jnp.asarray(mask))
        with torch.no_grad():
            got = t_gen.generate(model, port(cfg), torch.from_numpy(feats), 1, 2, 8,
                                 torch.from_numpy(mask), method=method, **kw)
        return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}
    enc = j_cap.encode(params, cfg, jnp.asarray(feats), jnp.asarray(mask))
    j_fn = {"greedy": j_gen.greedy_generate, "beam": j_gen.beam_search_generate}[method]
    t_fn = {"greedy": t_gen.greedy_generate, "beam": t_gen.beam_search_generate}[method]
    orig = j_vtp.vocab_topk_lse
    with mock.patch.object(jax, "default_backend", return_value="tpu"), \
         mock.patch.object(j_vtp, "vocab_topk_lse",
                           lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        want = jax.jit(lambda p, e: j_fn(p, cfg, e[0], e[1], 1, 2, 8, e[2], **kw))(params, enc)
    e = [torch.from_numpy(np.array(x)) for x in enc]
    with torch.no_grad():
        got = t_fn(model, port(cfg), e[0], e[1], 1, 2, 8, e[2], **kw)
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("flags", ["off", "fused"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_greedy_and_beam_tokens_identical(tiny_config, monkeypatch, option, flags):
    """Greedy and beam at K = 1, 2, 5, with the flags off and with the
    fused decode-step flags (the Pallas interpreter against the plain
    versions, the port's fused vocabulary branch forced as on the card).
    Luong and multi-head never reach bahdanau_attend."""
    cfg = _cfg(tiny_config, option)
    if flags == "fused":
        cfg.kernels.interpret = True
        for flag in FUSED_FLAGS:
            setattr(cfg.kernels, flag, True)
        monkeypatch.setattr(t_beam, "fused_vocab_eligible", lambda *a: True)
        monkeypatch.setattr(t_attn, "bahdanau_attend", None)  # a call would raise
    params, model = _pair(cfg, seed=6)
    rs = np.random.RandomState(6)
    feats = rs.randn(5, 10, 24).astype(np.float32)
    mask = _mask(5, 10, rs)
    want, got = _generate_both(cfg, params, model, feats, mask, "greedy")
    np.testing.assert_array_equal(got["generated_tokens"], want["generated_tokens"])
    assert sorted(got) == sorted(want)  # attention weights only with attention
    if "attention_weights" in want:
        _close(got["attention_weights"], want["attention_weights"], 1e-5)
    for K in (1, 2, 5):
        want, got = _generate_both(cfg, params, model, feats, mask, "beam", beam_size=K)
        np.testing.assert_array_equal(got["generated_tokens"], want["generated_tokens"])
        if flags == "off":
            np.testing.assert_array_equal(got["all_tokens"], want["all_tokens"])
            _close(got["all_scores"], want["all_scores"], 1e-4)
        else:
            _assert_same_hypotheses(got, want, 1e-4)


def _assert_same_hypotheses(got, want, tol):
    """The fused vocabulary projection rounds its operands to bfloat16, so
    a float32 rounding difference upstream of it can move a score by a
    bfloat16 ulp's worth (~1e-4 here) and swap two hypotheses whose scores
    are closer than that. Per clip: the same hypotheses, each sequence's
    score within ``tol``, and the same rank wherever a score stands more
    than 2 * ``tol`` from its neighbours."""
    for b in range(want["all_tokens"].shape[0]):
        w = {tuple(t): s for t, s in zip(want["all_tokens"][b].tolist(), want["all_scores"][b])}
        g = {tuple(t): s for t, s in zip(got["all_tokens"][b].tolist(), got["all_scores"][b])}
        assert sorted(g) == sorted(w), f"clip {b}"
        for seq, score in w.items():
            assert abs(g[seq] - score) <= tol, (b, seq)
        scores = want["all_scores"][b]
        for k, score in enumerate(scores):
            gaps = np.abs(np.delete(scores, k) - score)
            if gaps.size == 0 or gaps.min() > 2 * tol:
                np.testing.assert_array_equal(got["all_tokens"][b, k], want["all_tokens"][b, k])


def _write_raw_state(tmp, cfg):
    """An upstream raw state dict of a decoder with ``cfg``'s attention, its
    vocabulary.json and a base config."""
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast"])
    vocab.save(tmp / "vocabulary.json")
    cfg.data.max_vocab_size = len(vocab)
    (tmp / "base.json").write_text(json.dumps(cfg.to_dict()))
    params = init_params_numpy(port(cfg), len(vocab), seed=7)
    torch.save(state_dict_from_jax_params(params, port(cfg)), tmp / "state.pth")


@pytest.mark.parametrize("option", ["luong_general", "luong_concat", "multihead"])
def test_import_reference_attention_types_match_jax(tiny_config, tmp_path, option):
    cfg = _cfg(tiny_config, option)
    _write_raw_state(tmp_path, cfg)
    argv = ["--input", str(tmp_path / "state.pth"), "--vocabulary",
            str(tmp_path / "vocabulary.json"), "--config", str(tmp_path / "base.json"),
            "--attention-type", cfg.model.attention_type, "--log-level", "WARNING"]
    j_ir.main(argv + ["--output-dir", str(tmp_path / "jax")])
    got_sum = t_ir.main(argv + ["--output-dir", str(tmp_path / "port")])
    assert got_sum["attention_type"] == cfg.model.attention_type
    with open(tmp_path / "jax" / "model_for_inference.pth", "rb") as f:
        want = pickle.load(f)
    with open(got_sum["output"], "rb") as f:
        got = pickle.load(f)
    assert got["model_config"] == want["model_config"]
    assert got["vocabulary"] == want["vocabulary"]
    flat_w = jax.tree_util.tree_flatten_with_path(want["model_state_dict"])[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got["model_state_dict"])[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert any("attention" in jax.tree_util.keystr(p) for p, _ in flat_w)
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    assert Path(got_sum["vocabulary"]).read_text() == (tmp_path / "jax" /
                                                        "vocabulary.json").read_text()
