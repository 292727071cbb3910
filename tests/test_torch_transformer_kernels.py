"""The transformer family's kernel module and model functions on the CPU:
the plain versions of ``beam_self_attention`` and ``beam_cross_attention``
against the JAX Pallas kernels (run in interpret mode, as
tests/test_transformer.py runs them), and the port's encoder, eval-mode
teacher forcing and incremental decode step against the JAX package's.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.models import transformer as j_tr
from video_captioning_tpu.ops.transformer_attn_pallas import (
    beam_cross_attention as j_beam_cross,
    beam_self_attention as j_beam_self,
)
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.models import transformer as t_tr
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model, encode
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params
from video_captioning_tpu_torch.ops.transformer_attn import (
    beam_cross_attention,
    beam_cross_attention_reference,
    beam_self_attention,
    beam_self_attention_reference,
)

VOCAB = 32
HEADS = 4


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


@pytest.fixture
def tr_config(tiny_config):
    """tests/test_transformer.py's small transformer: D 16, 4 heads, 2 + 2
    blocks, S 10."""
    cfg = tiny_config
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim = cfg.model.decoder_hidden_dim
    cfg.model.transformer_num_layers = 2
    cfg.model.transformer_decoder_layers = 2
    cfg.model.transformer_num_heads = HEADS
    cfg.validate()
    return cfg


def _pair(cfg, seed=0):
    params = init_model(jax.random.PRNGKey(seed), cfg, VOCAB)
    model = VideoCaptioningModel(port(cfg), VOCAB)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port(cfg)))
    return params, model.eval()


def _features(cfg, B, seed, ragged):
    rs = np.random.RandomState(seed)
    feats = rs.randn(B, 10, cfg.model.cnn_feature_dim).astype(np.float32)
    if not ragged:
        return feats, None
    mask = np.ones((B, 10), np.float32)
    mask[1, 6:] = 0.0
    mask[-1, 3:] = 0.0
    return feats, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, order="C"))


# --------------------------------------------------------------- kernels

T_CACHE, D_MODEL = 9, 16


def _self_inputs(B, K, t, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B * K, D_MODEL).astype(np.float32)
    k = rs.randn(T_CACHE, B * K, D_MODEL).astype(np.float32)
    v = rs.randn(T_CACHE, B * K, D_MODEL).astype(np.float32)
    anc = rs.randint(0, K, (B, K, T_CACHE)).astype(np.int32)
    anc[:, :, t] = np.arange(K)  # the step's own rows lie in the writer's slot
    return q, k, v, anc


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [0, T_CACHE // 2, T_CACHE - 1])
@pytest.mark.parametrize("K", [2, 5])
def test_beam_self_attention_reference_matches_pallas(K, t, cache_dtype):
    """Random ancestry (column t the identity); bfloat16 caches are rounded
    once and handed to both sides, whose softmax and sums are float32."""
    q, k, v, anc = _self_inputs(3, K, t, seed=10 * K + t)
    jk, jv = (jnp.asarray(c).astype(cache_dtype) for c in (k, v))
    want = j_beam_self(jnp.asarray(q), jk, jv, jnp.asarray(anc), jnp.int32(t), HEADS, K,
                       interpret=True)
    tdt = getattr(torch, cache_dtype)
    tk, tv = _t(k).to(tdt), _t(v).to(tdt)
    got = beam_self_attention_reference(_t(q), tk, tv, _t(anc), t, HEADS, K)
    assert got.dtype == torch.float32 and got.shape == (3 * K, D_MODEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # On a CPU tensor the wrapper is the plain version.
    assert torch.equal(beam_self_attention(_t(q), tk, tv, _t(anc), t, HEADS, K), got)


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "one_row_masked"])
@pytest.mark.parametrize("K", [2, 5])
def test_beam_cross_attention_reference_matches_pallas(K, mask_kind):
    """A fully masked row gets uniform weights (the -1e9 fill), not NaN."""
    B, S = 3, 10
    rs = np.random.RandomState(K)
    q = rs.randn(B * K, D_MODEL).astype(np.float32)
    ck, cv = (rs.randn(B, S, D_MODEL).astype(np.float32) for _ in range(2))
    mask = None
    if mask_kind != "none":
        lengths = rs.randint(1, S + 1, size=B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
        if mask_kind == "one_row_masked":
            mask[1] = 0.0
    want_ctx, want_w = j_beam_cross(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                    None if mask is None else jnp.asarray(mask), HEADS, K,
                                    interpret=True)
    got = beam_cross_attention_reference(_t(q), _t(ck), _t(cv), _t(mask), HEADS, K)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_ctx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_w), rtol=0, atol=1e-5)
    if mask_kind == "one_row_masked":
        np.testing.assert_allclose(got[1][K:2 * K].numpy(), 1.0 / S, rtol=0, atol=1e-7)
    for a, b in zip(beam_cross_attention(_t(q), _t(ck), _t(cv), _t(mask), HEADS, K), got):
        assert torch.equal(a, b)


def test_beam_attention_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, anc = (_t(a) for a in _self_inputs(3, 2, 4, seed=0))
    with pytest.raises(ValueError, match="t = 9"):
        beam_self_attention(q, k, v, anc, 9, HEADS, 2)
    with pytest.raises(ValueError, match="anc"):
        beam_self_attention(q, k, v, anc.long(), 4, HEADS, 2)
    with pytest.raises(ValueError, match="K = 17"):
        beam_self_attention(torch.zeros(34, 16), k, v, anc, 4, HEADS, 17)
    with pytest.raises(ValueError, match="like k_lyr"):
        beam_self_attention(q, k, v.to(torch.bfloat16), anc, 4, HEADS, 2)
    with pytest.raises(ValueError, match="head width"):
        beam_cross_attention(torch.zeros(2, 258), torch.zeros(1, 3, 258),
                             torch.zeros(1, 3, 258), None, 2, 2)
    with pytest.raises(ValueError, match="mask"):
        beam_cross_attention(q, k[:3, :5].contiguous(), v[:3, :5].contiguous(),
                             torch.ones(3, 4), HEADS, 2)
    # Neither CPU nor CUDA: no plain-version fallback.
    with pytest.raises(ValueError, match="cpu or cuda"):
        beam_self_attention(q.to("meta"), k.to("meta"), v.to("meta"), anc.to("meta"), 4,
                            HEADS, 2)


# --------------------------------------------------------------- modules


@pytest.mark.parametrize("ragged", [True, False])
def test_encoder_matches_jax(tr_config, ragged):
    params, model = _pair(tr_config, seed=1)
    feats, mask = _features(tr_config, 3, seed=2, ragged=ragged)
    want = j_cap.encode(params, tr_config, jnp.asarray(feats),
                        None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = encode(model, port(tr_config), _t(feats), _t(mask))
    for name, a, b in zip(("encoder_outputs", "final", "mask"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("ragged", [True, False])
def test_apply_model_eval_matches_jax(tr_config, ragged):
    """Eval-mode teacher forcing: logits and the last block's head-mean
    cross-attention weights; without a mask the decoder gets None, as in
    the JAX package. Training mode without a generator draws no dropout
    and gives the same logits."""
    params, model = _pair(tr_config, seed=3)
    feats, mask = _features(tr_config, 3, seed=4, ragged=ragged)
    toks = np.random.RandomState(5).randint(0, VOCAB, (3, 7)).astype(np.int32)
    want = j_cap.apply_model(params, tr_config, jnp.asarray(feats), jnp.asarray(toks),
                             None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = apply_model(model, port(tr_config), _t(feats), _t(toks).long(), _t(mask))
    for key in ("logits", "attention_weights", "encoder_outputs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=2e-5,
                                   err_msg=key)
    with torch.no_grad():
        trained = apply_model(model, port(tr_config), _t(feats), _t(toks).long(), _t(mask),
                              train=True)
    assert torch.equal(trained["logits"], got["logits"])


@pytest.mark.parametrize("merge_qkv", [False, True])
def test_decode_step_matches_parallel_decoder(tr_config, merge_qkv):
    """Each incremental step (row t of the caches written in place) equals
    column t of the JAX package's parallel decoder, logits and weights."""
    params, model = _pair(tr_config, seed=6)
    feats, mask = _features(tr_config, 2, seed=7, ragged=True)
    enc, _, jmask = j_cap.encode(params, tr_config, jnp.asarray(feats), jnp.asarray(mask))
    T = 7
    toks = np.random.RandomState(8).randint(0, VOCAB, (2, T)).astype(np.int32)
    want = j_tr.apply_transformer_decoder(params["decoder"], tr_config, enc, jnp.asarray(toks),
                                          jmask)
    cfg = port(tr_config)
    dec, enc_t, mask_t = model.decoder, _t(np.asarray(enc)), _t(mask)
    with torch.no_grad():
        cross_kv = t_tr.precompute_cross_kv(dec, enc_t)
        qkv = t_tr.merge_self_attn_qkv(dec) if merge_qkv else None
        state = t_tr.init_decode_state(dec, cfg, 2, torch.float32, torch.device("cpu"))
        for t in range(T):
            logits, state, w = t_tr.decode_step(dec, cfg, _t(toks[:, t]).long(), state, t,
                                                cross_kv, mask_t, qkv)
            np.testing.assert_allclose(logits.numpy(), np.asarray(want["logits"][:, t]),
                                       rtol=0, atol=2e-5, err_msg=f"logits t={t}")
            np.testing.assert_allclose(w.numpy(), np.asarray(want["attention_weights"][:, t]),
                                       rtol=0, atol=2e-5, err_msg=f"weights t={t}")


def test_decode_positions_past_the_table_reuse_its_last_row(tr_config, caplog):
    """The JAX step clamps t to the position table's last row and warns
    when the caches outgrow it; so does the port."""
    params, model = _pair(tr_config, seed=9)
    cfg = port(tr_config)
    rows = cfg.model.max_sequence_length + 1
    with torch.no_grad(), caplog.at_level("WARNING"):
        state = t_tr.init_decode_state(model.decoder, cfg, 2, torch.float32,
                                       torch.device("cpu"), max_positions=rows + 3)
    assert state["k"][0].shape[0] == rows + 3
    assert "reuse the last row" in caplog.text
    toks = torch.tensor([3, 4])
    last = model.decoder.pos_embedding[rows - 1]
    assert torch.equal(t_tr._embed(model.decoder, toks, rows + 2, torch.float32),
                       model.decoder.embedding(toks) + last)
    with pytest.raises(ValueError, match="position table"):
        t_tr.apply_transformer_encoder(model.encoder, cfg, torch.zeros(1, 11, 24), None)
