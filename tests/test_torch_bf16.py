"""bfloat16 serving (``compute_dtype="bfloat16"``) in the port against the
JAX package's bfloat16 parameters on the CPU: the predictor casts every
float32 parameter once; encoder outputs, decode-step logits and states and
teacher-forced logits stay within 2e-2 of the largest JAX value for every
attention option; greedy tokens agree with JAX's on at least 90% of 64
sharpened clips (the beam figure is printed); and the transformer family
loads and serves in bfloat16 (held against JAX in
tests/test_torch_bf16_transformer.py). bfloat16 under the fused
decode-step flags is held in tests/test_torch_bf16_fused.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import attention as j_attn
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import decoder as j_dec
from video_captioning_tpu.models import init_model
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models import decoder as t_dec
from video_captioning_tpu_torch.models.captioner import apply_model, encode

CAPTIONS = ["a man rides a horse", "a dog runs in the park", "a cat sleeps on a bed",
            "the woman slices an onion", "a bird flies over the water"]
OPTIONS = {"bahdanau": ("bahdanau", "general", True), "luong_general": ("luong", "general", True),
           "luong_concat": ("luong", "concat", True), "multihead": ("multihead", "general", True),
           "no_attention": ("bahdanau", "general", False)}
REL = 2e-2


def _config(option="bahdanau"):
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 16, 16
    m.embedding_dim, m.attention_dim, m.attention_num_heads = 12, 16, 4
    m.max_sequence_length, m.video_sequence_length = 8, 10
    m.attention_type, m.luong_score, m.use_attention = OPTIONS[option]
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    return cfg


def _package(directory, cfg, seed=0, sharpen=3.0, end_bias=None):
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    params = jax.tree_util.tree_map(np.array,
                                    init_model(jax.random.PRNGKey(seed), cfg, len(vocab)))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * sharpen
    if end_bias is not None:
        out["bias"][vocab.end_idx] = end_bias
    return CheckpointManager(Path(directory)).save_model_for_inference(params, vocab, cfg)


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _near(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_bf16_encoder_steps_and_logits_match_jax(tmp_path, option, interpret):
    """interpret=True: the encoder's lstm_seq contract on both sides (the
    Pallas interpreter, the port's plain version)."""
    cfg = _config(option)
    cfg.kernels.interpret = interpret
    pkg = _package(tmp_path, cfg)
    jp = JaxPredictor(Path(pkg), config=cfg, compute_dtype="bfloat16")
    tp = VideoCaptionPredictor(pkg, config=_port(cfg), device="cpu", compute_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tp.model.parameters())
    pcfg, params = tp.config, jp.params
    rs = np.random.RandomState(1)
    feats = rs.randn(4, 10, 24).astype(np.float32)
    with torch.no_grad():
        t_enc, t_final, t_mask = encode(tp.model, pcfg, torch.from_numpy(feats))
    j_enc, j_final, j_mask = j_cap.encode(params, cfg, jnp.asarray(feats))
    assert t_enc.dtype == torch.float32 and j_enc.dtype == jnp.float32
    _near(t_enc, j_enc, "encoder outputs")
    _near(t_final, j_final, "final state")
    dp, dec = params["decoder"], tp.model.decoder
    j_cache = (j_attn.precompute(cfg, dp["attention"], j_enc) if cfg.model.use_attention
               else {})
    j_state = j_dec.init_hidden_state(dp, cfg, j_final)
    with torch.no_grad():
        t_cache = t_dec.precompute_attention(dec, t_enc)
        t_state = t_dec.init_hidden_state(dec, pcfg, t_final)
        tokens = np.array([1, 5, 7, 9])
        for step in range(3):
            tok = (tokens + step) % 20
            j_logits, j_state, _ = j_dec.decoder_step(dp, cfg, jnp.asarray(tok, jnp.int32),
                                                      j_state, j_enc, j_cache, j_mask)
            t_logits, t_state, _ = t_dec.decoder_step(dec, pcfg, torch.from_numpy(tok), t_state,
                                                      t_enc, t_cache, t_mask)
            assert t_logits.dtype == torch.float32
            _near(t_logits, j_logits, f"step {step} logits")
            _near(t_state[0], j_state[0], f"step {step} h")
        inp = rs.randint(0, 20, (4, 6)).astype(np.int32)
        t_out = apply_model(tp.model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp))
    j_out = j_cap.apply_model(params, cfg, jnp.asarray(feats), jnp.asarray(inp))
    _near(t_out["logits"], j_out["logits"], "teacher-forced logits")


def test_bf16_greedy_clip_agreement_with_jax(tmp_path):
    """64 clips, the protocol of benchmarks/bf16_parity_gate.py (vocabulary
    projection sharpened x3, END suppressed so every decode runs its full
    length): greedy clip agreement with JAX's bfloat16 run >= 0.9; beam-5's
    is printed, not gated (bfloat16 beams diverge on near ties)."""
    cfg = _config()
    pkg = _package(tmp_path, cfg, seed=3, end_bias=-1e9)
    jp = JaxPredictor(Path(pkg), compute_dtype="bfloat16")
    tp = VideoCaptionPredictor(pkg, device="cpu", compute_dtype="bfloat16")
    rs = np.random.RandomState(7)
    feats = [rs.randn(10, 24).astype(np.float32) for _ in range(64)]
    agreement = {}
    for method in ("greedy", "beam"):
        want = np.array([r["tokens"] for r in jp.predict_batch(feats, method=method,
                                                                max_length=8)])
        got = np.array([r["tokens"] for r in tp.predict_batch(feats, method=method,
                                                               max_length=8)])
        agreement[method] = float((got == want).all(axis=1).mean())
    print(f"bf16 clip agreement with JAX bf16 on 64 clips: {agreement}")
    assert agreement["greedy"] >= 0.9


@pytest.mark.parametrize("flag", ["transformer"])
def test_bf16_with_a_fused_decode_flag_is_refused_at_load(tmp_path, flag):
    """No family is refused in bfloat16 any more: the transformer loads and
    serves greedy and beam-5 in float32 and in bfloat16, with its fused
    beam attention too (held against JAX in
    tests/test_torch_bf16_transformer.py)."""
    cfg = _config()
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim, cfg.model.transformer_num_heads = 16, 4
    pkg = _package(tmp_path, cfg)
    feats = np.random.RandomState(2).randn(10, 24).astype(np.float32)
    for fused in (False, True):
        pcfg = _port(cfg)
        pcfg.kernels.transformer_fused_beam_attn = fused
        for dtype in (None, "bfloat16"):
            tp = VideoCaptionPredictor(pkg, config=pcfg, device="cpu", compute_dtype=dtype)
            want = torch.bfloat16 if dtype else torch.float32
            assert all(p.dtype == want for p in tp.model.parameters())
            for method in ("greedy", "beam"):
                res = tp.predict_from_features(feats, method=method, max_length=6)
                assert isinstance(res["caption"], str) and res["tokens"]
                assert all(0 <= t < len(tp.vocabulary) for t in res["tokens"])


def test_serve_cli_passes_the_compute_dtype(monkeypatch):
    from video_captioning_tpu_torch.cli import serve
    from video_captioning_tpu_torch.inference import predictor, server

    seen = {}

    class Stop(Exception):
        pass

    def fake_predictor(path, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(predictor, "VideoCaptionPredictor", fake_predictor)
    monkeypatch.setattr(server, "CaptionServer", None)
    with pytest.raises(Stop):
        serve.main(["--model-path", "m.pth", "--device", "cpu", "--compute-dtype", "bfloat16"])
    assert seen == {"device": "cpu", "compute_dtype": "bfloat16", "decode_int8": "off"}
