"""The port's model functions against the JAX package on the same weights
(through the bridge) and the same numpy inputs: encoder (both recurrence
paths), Bahdanau attend / attend_beam, decoder step and beam step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.models import attention as j_attn
from video_captioning_tpu.models import decoder as j_dec
from video_captioning_tpu.models import encoder as j_enc
from video_captioning_tpu.models import init_model
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.models import attention as t_attn
from video_captioning_tpu_torch.models import decoder as t_dec
from video_captioning_tpu_torch.models import encoder as t_enc
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params

VOCAB = 23
# float32 on both sides; matmul sum order differs between XLA:CPU and
# torch, so values agree to a few float32 ulps of O(1) activations.
ATOL = 2e-5


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _pair(cfg, seed=0):
    params = init_model(jax.random.PRNGKey(seed), cfg, VOCAB)
    pcfg = port(cfg)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return params, model.eval()


def _ragged_mask(B, T, rs):
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_encoder_matches_jax(tiny_config, interpret, ragged):
    """interpret=False: float32 lstm_scan on both sides (the kernel gate is
    on but CPU is not a kernel backend). interpret=True: the lstm_seq
    contract on both sides (JAX Pallas interpreter vs the port's plain
    version)."""
    cfg = tiny_config
    cfg.kernels.interpret = interpret
    params, model = _pair(cfg)
    rs = np.random.RandomState(1)
    feats = rs.randn(5, 10, cfg.model.cnn_feature_dim).astype(np.float32)
    mask = _ragged_mask(5, 10, rs) if ragged else None
    want_enc, want_final = j_enc.apply_encoder(
        params["encoder"], cfg, jnp.asarray(feats), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got_enc, got_final = t_enc.apply_encoder(
            model.encoder, port(cfg), torch.from_numpy(feats),
            None if mask is None else torch.from_numpy(mask))
    _close(got_enc, want_enc)
    _close(got_final, want_final)


def _attn_inputs(cfg, rs, K=None):
    B, S = 4, 10
    E, D = cfg.model.encoder_hidden_dim, cfg.model.decoder_hidden_dim
    enc = rs.randn(B, S, E).astype(np.float32)
    hid = rs.randn(*((B, D) if K is None else (B, K, D))).astype(np.float32)
    mask = _ragged_mask(B, S, rs)
    return enc, hid, mask


@pytest.mark.parametrize("beam", [False, True])
def test_bahdanau_attention_matches_jax(tiny_config, beam):
    cfg = tiny_config
    params, model = _pair(cfg, seed=2)
    rs = np.random.RandomState(2)
    enc, hid, mask = _attn_inputs(cfg, rs, K=3 if beam else None)
    jp = params["decoder"]["attention"]
    jcache = j_attn.precompute(cfg, jp, jnp.asarray(enc))
    jfn = j_attn.attend_beam if beam else j_attn.attend
    want_ctx, want_w = jfn(cfg, jp, jcache, jnp.asarray(enc), jnp.asarray(hid), jnp.asarray(mask))
    attn = model.decoder.attention
    with torch.no_grad():
        tcache = t_attn.precompute(attn, torch.from_numpy(enc))
        tfn = t_attn.attend_beam if beam else t_attn.attend
        got_ctx, got_w = tfn(attn, tcache, torch.from_numpy(enc), torch.from_numpy(hid),
                             torch.from_numpy(mask))
    _close(tcache["enc_proj"], jcache["enc_proj"])
    _close(got_ctx, want_ctx)
    _close(got_w, want_w)


@pytest.mark.parametrize("beam", [False, True])
def test_decoder_step_matches_jax(tiny_config, beam):
    cfg = tiny_config
    params, model = _pair(cfg, seed=4)
    rs = np.random.RandomState(4)
    K = 3 if beam else 1
    enc, _, mask = _attn_inputs(cfg, rs)
    B = enc.shape[0]
    final = rs.randn(B, cfg.model.encoder_hidden_dim).astype(np.float32)
    tokens = rs.randint(0, VOCAB, size=(B, K) if beam else (B,))

    dp = params["decoder"]
    enc_j, mask_j = jnp.asarray(enc), jnp.asarray(mask)
    cache_j = j_attn.precompute(cfg, dp["attention"], enc_j)
    state_j = j_dec.init_hidden_state(dp, cfg, jnp.repeat(jnp.asarray(final), K, axis=0))
    dec = model.decoder
    with torch.no_grad():
        enc_t, mask_t = torch.from_numpy(enc), torch.from_numpy(mask)
        cache_t = t_attn.precompute(dec.attention, enc_t)
        state_t = t_dec.init_hidden_state(
            dec, port(cfg), torch.from_numpy(final).repeat_interleave(K, dim=0))
        for step in range(3):  # carry the state through a few steps
            tok = tokens if step == 0 else (tokens + step) % VOCAB
            if beam:
                want_logits, state_j, want_w = j_dec.decoder_step_beam(
                    dp, cfg, jnp.asarray(tok, jnp.int32), state_j, enc_j, cache_j, mask_j)
                got_logits, state_t, got_w = t_dec.decoder_step_beam(
                    dec, torch.from_numpy(tok), state_t, enc_t, cache_t, mask_t)
            else:
                want_logits, state_j, want_w = j_dec.decoder_step(
                    dp, cfg, jnp.asarray(tok, jnp.int32), state_j, enc_j, cache_j, mask_j)
                got_logits, state_t, got_w = t_dec.decoder_step(
                    dec, torch.from_numpy(tok), state_t, enc_t, cache_t, mask_t)
            _close(got_logits, want_logits)
            _close(got_w, want_w)
            _close(state_t[0], state_j[0])
            _close(state_t[1], state_j[1])
