"""The kernels' domain gates on the CPU: ``lstm_seq_eligible`` decides
whether the encoder's recurrence takes the ``lstm_seq`` /
``lstm_seq_train`` kernels, and ``fused_vocab_eligible`` whether the beam
step takes ``vocab_topk_lse``. The card's limits are patched in as
``chip_smoke.gate_as_on_card`` does; an H = 1024 encoder, outside the
recurrence kernels' domain on the card, serves and trains as the JAX
package's float32 scan does."""

import importlib
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.training.losses import label_smoothed_cross_entropy as j_loss
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.generation import beam as t_beam
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models import encoder as t_encoder
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model
from video_captioning_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.ops.vocab_topk import vocab_partition
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy

t_lstm_seq = importlib.import_module("video_captioning_tpu_torch.ops.lstm_seq")
CARD_LIMIT = 600  # kMaxHidden of csrc/lstm_seq_fwd.cuh, both recurrence kernels
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.fixture
def card_limits(monkeypatch):
    """The kernels' limit as the card's library reports it, and the gate
    evaluated as on the card whatever the device, so a CPU run takes the
    card's branch."""
    for module in (t_lstm_seq, t_encoder):
        monkeypatch.setattr(module, "kernel_max_hidden", lambda train=False: CARD_LIMIT)
    gate = t_lstm_seq.lstm_seq_eligible
    monkeypatch.setattr(t_encoder, "lstm_seq_eligible",
                        lambda H, dtype, device, train=False: gate(H, dtype, CUDA, train))


@pytest.mark.parametrize("train", [False, True])
def test_lstm_seq_gate_on_the_card(card_limits, train):
    gate = t_lstm_seq.lstm_seq_eligible
    assert gate(512, torch.float32, CUDA, train) and gate(512, torch.bfloat16, CUDA, train)
    assert gate(600, torch.float32, CUDA, train)
    assert not gate(1024, torch.float32, CUDA, train)
    assert not gate(604, torch.float32, CUDA, train)   # above the limit
    assert not gate(102, torch.float32, CUDA, train)  # not a multiple of 8
    assert not gate(512, torch.float16, CUDA, train)
    # The plain versions take every H.
    assert gate(1024, torch.float32, CPU, train) and gate(102, torch.float32, CPU, train)


@pytest.mark.parametrize("H,takes", [(512, True), (1024, False)])
def test_encoder_dispatch_is_decided_once_and_logged(card_limits, caplog, H, takes):
    cfg = PortConfig()
    cfg.model.cnn_feature_dim, cfg.model.encoder_hidden_dim = 24, H
    enc = t_encoder.Encoder(cfg)
    with caplog.at_level(logging.INFO, logger=t_encoder.__name__):
        for _ in range(3):
            assert enc.takes_kernel(torch.float32, CUDA, train=False) is takes
            assert enc.takes_kernel(torch.float32, CUDA, train=True) is takes
    lines = [r.getMessage() for r in caplog.records if "lstm_seq_eligible" in r.getMessage()]
    assert len(lines) == 2  # once for eval, once for training
    assert all(f"H={H}" in line and f"limit {CARD_LIMIT}" in line for line in lines)
    assert all(("lstm_scan" in line) is not takes for line in lines)


@pytest.mark.parametrize("H", [16, 512, 1024, 1152, 1160, 1216, 2048])
def test_fused_vocab_gate_checks_the_decoder_width(H):
    cfg = PortConfig()
    cfg.model.decoder_hidden_dim = H
    cfg.kernels.use_fused_vocab_topk = True
    try:
        vocab_partition(640, H, 10000, 132)
        fits = True
    except ValueError:
        fits = False
    assert fits == (H <= 1152)
    assert t_beam.fused_vocab_eligible(cfg, CUDA, 128, 5, 10000) is fits
    assert not t_beam.fused_vocab_eligible(cfg, CPU, 128, 5, 10000)


def _wide_config(tiny_config):
    cfg = tiny_config
    cfg.model.encoder_hidden_dim = 1024  # a width config.py accepts
    cfg.data.vocab_threshold = 1
    cfg.validate()
    return cfg


@pytest.fixture
def no_recurrence_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the recurrence kernel ran outside its domain")

    monkeypatch.setattr(t_encoder, "lstm_seq", refuse)
    monkeypatch.setattr(t_encoder, "lstm_seq_train", refuse)


def test_wide_encoder_serves_as_jax(tiny_config, tmp_path, card_limits, no_recurrence_kernel):
    """encoder_hidden_dim = 1024 with the kernel flags on and
    ``kernels.interpret`` (the card's branch on the CPU): the gate sends the
    encoder to lstm_scan, and beam and greedy tokens equal the JAX
    predictor's (its lax.scan off the TPU)."""
    cfg = _wide_config(tiny_config)
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast", "the cat sleeps"])
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(1), cfg, len(vocab)))
    params["decoder"]["output_projection"]["kernel"] = \
        params["decoder"]["output_projection"]["kernel"] * 3.0
    pkg = CheckpointManager(tmp_path).save_model_for_inference(params, vocab, cfg)
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    port_cfg.kernels.interpret = True
    assert port_cfg.kernels.use_pallas_lstm_seq and port_cfg.kernels.use_pallas_lstm_seq_train
    feats = [np.random.RandomState(i).randn(10, 24).astype(np.float32) for i in range(3)]
    jp, tp = JaxPredictor(pkg), VideoCaptionPredictor(pkg, config=port_cfg, device="cpu")
    for method in ("beam", "greedy"):
        want = jp.predict_batch(feats, method=method, beam_size=3)
        got = tp.predict_batch(feats, method=method, beam_size=3)
        assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want]


def test_wide_encoder_trains_as_jax(tiny_config, card_limits, no_recurrence_kernel):
    """One teacher-forced step at encoder_hidden_dim = 1024, dropout off:
    the loss within 1e-5 relative and every gradient within 1e-4 of its
    largest value of jax.value_and_grad of the JAX loss (lax.scan)."""
    cfg = _wide_config(tiny_config)
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(2), cfg, 23))
    pcfg = PortConfig.from_dict(cfg.to_dict())
    pcfg.kernels.interpret = True
    model = VideoCaptioningModel(pcfg, 23)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    rs = np.random.RandomState(3)
    feats = rs.randn(3, 10, 24).astype(np.float32)
    inp = rs.randint(0, 23, (3, 8)).astype(np.int32)
    tgt = rs.randint(1, 23, (3, 8)).astype(np.int32)

    def j_loss_fn(p):
        out = j_cap.apply_model(p, cfg, jnp.asarray(feats), jnp.asarray(inp), train=True)
        return j_loss(out["logits"], jnp.asarray(tgt), 0, 0.1)

    want_loss, want = jax.value_and_grad(j_loss_fn)(params)
    out = apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp), train=True)
    loss = label_smoothed_cross_entropy(out["logits"], torch.from_numpy(tgt), 0, 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = jax_params_from_state_dict({k: p.grad for k, p in model.named_parameters()}, pcfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_w)
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
