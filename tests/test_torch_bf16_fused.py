"""bfloat16 serving and training under the fused decode-step flags
(``kernels.use_pallas_lstm``, ``use_pallas_attention``,
``use_fused_vocab_topk``) in the port against the JAX package's bfloat16
run on the CPU. The JAX kernels take no bfloat16 operands: their wrappers
cast every operand to float32 (``ops/lstm_pallas.py:113-118``,
``ops/attention_pallas.py:145-152``) or x to bfloat16
(``ops/vocab_topk_pallas.py:211``), and the port's wrappers cast the
same way. JAX runs its Pallas kernels in interpret mode, the port its
plain versions. Held: decode steps (logits and states) and the fused
vocabulary expansion within 2e-2 of the largest JAX value
(``tests/test_torch_bf16.py``'s tolerance), greedy clip agreement with
JAX at least 0.9 on 64 sharpened clips (beam printed), and one bfloat16
training step with each flag whose validation greedy decode runs."""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bf16 import _config, _near, _package, _port
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import attention as j_attn
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import decoder as j_dec
from video_captioning_tpu.ops import vocab_topk_pallas as j_vtp
from video_captioning_tpu_torch.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.generation import beam as t_beam
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models import decoder as t_dec
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, encode
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params
from video_captioning_tpu_torch.ops import launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.vocab_topk import pad_vocab_weights, vocab_topk_lse
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer

FLAGS = ("use_pallas_lstm", "use_pallas_attention", "use_fused_vocab_topk")
MIN_GREEDY_AGREEMENT = 0.9


def _flag_config(flag):
    cfg = _config()
    setattr(cfg.kernels, flag, True)
    cfg.kernels.interpret = True
    return cfg


def _predictors(tmp_path, cfg, **package_kw):
    pkg = _package(tmp_path, cfg, **package_kw)
    jp = JaxPredictor(Path(pkg), config=cfg, compute_dtype="bfloat16")
    tp = VideoCaptionPredictor(pkg, config=_port(cfg), device="cpu", compute_dtype="bfloat16")
    return jp, tp


@pytest.mark.parametrize("flag", FLAGS)
def test_bf16_fused_decode_steps_match_jax(tmp_path, flag):
    """Three greedy steps and two beam steps (K = 2) of the decoder with
    bfloat16 parameters and the flag on: logits and states float32 on both
    sides and within 2e-2; with ``use_fused_vocab_topk`` the expansion
    of the last beam step's pre-vocab state through both packages'
    ``vocab_topk_lse`` as well (top-k values and logsumexp, the same
    tokens)."""
    cfg = _flag_config(flag)
    jp, tp = _predictors(tmp_path, cfg)
    assert all(p.dtype == torch.bfloat16 for p in tp.model.parameters())
    pcfg, params, dec = tp.config, jp.params, tp.model.decoder
    dp = params["decoder"]
    feats = np.random.RandomState(1).randn(4, 10, 24).astype(np.float32)
    mask_np = np.ones((4, 10), np.float32)
    mask_np[1, 6:] = 0
    j_enc, j_final, j_mask = j_cap.encode(params, cfg, jnp.asarray(feats), jnp.asarray(mask_np))
    j_cache = j_attn.precompute(cfg, dp["attention"], j_enc)
    with torch.no_grad():
        t_enc, t_final, t_mask = encode(tp.model, pcfg, torch.from_numpy(feats),
                                        torch.from_numpy(mask_np))
        t_cache = t_dec.precompute_attention(dec, t_enc)
    _near(t_enc, j_enc, "encoder outputs")

    j_state = j_dec.init_hidden_state(dp, cfg, j_final)
    with torch.no_grad():
        t_state = t_dec.init_hidden_state(dec, pcfg, t_final)
    for step in range(3):
        tok = (np.array([1, 5, 7, 9]) + step) % 20
        j_logits, j_state, j_w = j_dec.decoder_step(dp, cfg, jnp.asarray(tok, jnp.int32),
                                                    j_state, j_enc, j_cache, j_mask)
        with torch.no_grad():
            t_logits, t_state, t_w = t_dec.decoder_step(dec, pcfg, torch.from_numpy(tok),
                                                        t_state, t_enc, t_cache, t_mask)
        assert j_state[0].dtype == jnp.float32
        assert t_logits.dtype == t_state[0].dtype == t_state[1].dtype == torch.float32
        _near(t_logits, j_logits, f"greedy step {step} logits")
        _near(t_state[0], j_state[0], f"greedy step {step} h")
        _near(t_state[1], j_state[1], f"greedy step {step} c")
        _near(t_w, j_w, f"greedy step {step} weights")

    K = 2
    j_state = j_dec.init_hidden_state(dp, cfg, jnp.repeat(j_final, K, axis=0))
    with torch.no_grad():
        t_state = t_dec.init_hidden_state(dec, pcfg, t_final.repeat_interleave(K, dim=0))
    for step in range(2):
        tok = (np.arange(8).reshape(4, K) * 3 + step) % 20
        j_pre, j_state, _ = j_dec.decoder_step_beam_core(
            dp, cfg, jnp.asarray(tok, jnp.int32), j_state, j_enc, j_cache, j_mask)
        with torch.no_grad():
            t_pre, t_state, _ = t_dec.decoder_step_beam_core(
                dec, pcfg, torch.from_numpy(tok), t_state, t_enc, t_cache, t_mask)
        assert t_pre.dtype == t_state[0].dtype == torch.float32
        _near(t_pre, j_pre, f"beam step {step} pre-vocab state")
        _near(t_state[0], j_state[0], f"beam step {step} h")
    if flag == "use_fused_vocab_topk":
        k = 5
        jw, jb, _ = j_vtp.pad_vocab_weights(dp["output_projection"]["kernel"].astype(jnp.float32),
                                            dp["output_projection"]["bias"].astype(jnp.float32),
                                            vt=2048)
        j_vals, j_idx, j_lse = j_vtp.vocab_topk_lse(j_pre, jw, jb, k, interpret=True)
        proj = dec.output_projection
        tw, tb, _ = pad_vocab_weights(proj.weight.T, proj.bias)
        reset_launch_counts()
        t_vals, t_idx, t_lse = vocab_topk_lse(t_pre.to(torch.bfloat16), tw, tb, k)
        assert sum(launch_counts().values()) == 0  # the plain version on the CPU
        _near(t_vals, j_vals, "fused vocabulary top-k values")
        _near(t_lse, j_lse, "fused vocabulary logsumexp")
        same = (t_idx.numpy() == np.asarray(j_idx)).all(axis=1).mean()
        print(f"bf16 fused vocabulary: rows with the same top-{k} tokens {same:.3f}")


@pytest.mark.parametrize("flag", FLAGS)
def test_bf16_fused_greedy_clip_agreement_with_jax(tmp_path, flag):
    """64 clips under ``benchmarks/bf16_parity_gate.py``'s protocol (the
    vocabulary projection sharpened x3, END suppressed): greedy clip
    agreement with JAX's bfloat16 run under the same flag >= 0.9; beam-5's
    is printed, not gated. ``use_fused_vocab_topk`` drives both beams
    through the fused expansion (JAX's gate forced as
    tests/test_pallas_kernels.py does, the port's by patching
    ``fused_vocab_eligible``)."""
    cfg = _flag_config(flag)
    jp, tp = _predictors(tmp_path, cfg, seed=3, end_bias=-1e9)
    rs = np.random.RandomState(7)
    feats = [rs.randn(10, 24).astype(np.float32) for _ in range(64)]
    agreement = {}
    fused_vocab = flag == "use_fused_vocab_topk"
    orig = j_vtp.vocab_topk_lse
    for method in ("greedy", "beam"):
        force = fused_vocab and method == "beam"
        with mock.patch.object(jax, "default_backend",
                               return_value="tpu" if force else jax.default_backend()), \
             mock.patch.object(j_vtp, "vocab_topk_lse",
                               lambda *a, **kw: orig(*a, **{**kw, "interpret": True})):
            want = np.array([r["tokens"] for r in jp.predict_batch(feats, method=method,
                                                                    max_length=8)])
        with mock.patch.object(t_beam, "fused_vocab_eligible", return_value=fused_vocab):
            got = np.array([r["tokens"] for r in tp.predict_batch(feats, method=method,
                                                                   max_length=8)])
        agreement[method] = float((got == want).all(axis=1).mean())
    print(f"bf16 {flag} clip agreement with JAX bf16 on 64 clips: {agreement}")
    assert agreement["greedy"] >= MIN_GREEDY_AGREEMENT


@pytest.mark.parametrize("flag", FLAGS)
def test_bf16_training_step_with_a_fused_flag_validates(tmp_path, flag):
    """A bfloat16 trainer builds with the flag, takes one step (float32
    master gradients) and its validation's greedy decode runs through the
    flag's wrapper on the bfloat16 copy of the weights; the decoded tokens
    equal the flag-off copy's decode where the flag leaves the greedy
    path's numbers alone (``use_fused_vocab_topk`` acts on beams only)."""
    from test_torch_bf16_train import VOCAB, _batch
    from test_torch_bf16_train import _config as train_config
    from test_torch_bf16_train import _port as train_port
    from video_captioning_tpu.models import init_model

    cfg = train_config()
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(1), cfg, VOCAB))
    pcfg = train_port(cfg, tmp_path)
    setattr(pcfg.kernels, flag, True)
    vocab = Vocabulary(pcfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs"])
    batch = _batch(cfg)

    class Loader(list):
        def set_epoch(self, epoch):
            pass

    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    trainer = VideoCaptioningTrainer(model, pcfg, vocab, Loader([batch]), Loader([batch]),
                                     device="cpu")
    trainer.generator = None
    calls = {}
    loss = trainer.train_step(batch)
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in trainer.model.parameters())
    from video_captioning_tpu_torch.models import attention as t_attn

    real_cell, real_attend = t_dec.lstm_cell_fused, t_attn.bahdanau_attend
    with mock.patch.object(t_dec, "lstm_cell_fused",
                           lambda *a: calls.setdefault("cell", []).append(1) or real_cell(*a)), \
         mock.patch.object(t_attn, "bahdanau_attend",
                           lambda *a: calls.setdefault("attend", []).append(1)
                           or real_attend(*a)):
        metrics = trainer.validate_epoch()
    assert np.isfinite(metrics["loss"])
    assert trainer._eval_model.decoder.output_projection.weight.dtype == torch.bfloat16
    if flag == "use_pallas_lstm":
        assert len(calls["cell"]) == cfg.model.decoder_num_layers * cfg.model.max_sequence_length
    elif flag == "use_pallas_attention":
        # eval-mode teacher forcing's T steps, then the greedy decode's
        assert len(calls["attend"]) == 2 * cfg.model.max_sequence_length
    else:
        assert not calls
