"""Training the transformer family in the port on the CPU, against the JAX
package on the same weights (through the bridge) and the same numpy
inputs: the teacher-forced loss and every gradient against
``jax.value_and_grad`` with dropout off, the dropout sites (count, order
and shapes equal to the JAX package's), dropout in eval mode and from a
seed, a tiny transformer memorizing its captions through ``cli.train``,
and the package it writes served by the JAX predictor."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.inference import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.models import transformer as j_tr
from video_captioning_tpu.training.losses import label_smoothed_cross_entropy as j_loss
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models import transformer as t_tr
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model
from video_captioning_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy

VOCAB = 29
CAPTIONS = ["a man is running", "a dog is barking", "a cat is sleeping", "a bird is flying"]


def port(cfg) -> PortConfig:
    return PortConfig.from_dict(cfg.to_dict())


@pytest.fixture
def tr_config(tiny_config):
    """A small transformer: D 16, 4 heads, 2 encoder and 3 decoder blocks
    (unequal, so the site counts tell the halves apart), S 10, T 8."""
    cfg = tiny_config
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim = cfg.model.decoder_hidden_dim
    cfg.model.transformer_num_layers = 2
    cfg.model.transformer_decoder_layers = 3
    cfg.model.transformer_num_heads = 4
    cfg.validate()
    return cfg


def _pair(cfg, seed):
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(seed), cfg, VOCAB))
    pcfg = port(cfg)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return params, model, pcfg


def _batch(cfg, B=3, seed=4):
    """Seeded features with padded frames (ragged lengths, the first row
    full), tokens, and targets with a PAD tail."""
    rs = np.random.RandomState(seed)
    S = cfg.model.video_sequence_length
    feats = rs.randn(B, S, cfg.model.cnn_feature_dim).astype(np.float32)
    lengths = np.array([S, 4, 7, 1, 9][:B])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    feats = feats * mask[:, :, None]
    inp = rs.randint(0, VOCAB, (B, cfg.model.max_sequence_length)).astype(np.int32)
    tgt = rs.randint(1, VOCAB, (B, cfg.model.max_sequence_length)).astype(np.int32)
    tgt[0, 5:] = 0
    return feats, mask, inp, tgt


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("masked", [True, False])
def test_loss_and_every_gradient_match_jax(tr_config, masked):
    """train=True with transformer_dropout=0 (a generator given all the
    same): the label-smoothed loss within 1e-5 relative and each gradient
    within 1e-4 of its largest value (floored at 1e-3 of the largest
    gradient anywhere) of jax.value_and_grad of the JAX loss; padded frames
    in the batch when ``masked``."""
    cfg = tr_config
    cfg.model.transformer_dropout = 0.0
    params, model, pcfg = _pair(cfg, seed=3)
    feats, mask, inp, tgt = _batch(cfg)
    j_mask = jnp.asarray(mask) if masked else None

    def j_loss_fn(p):
        out = j_cap.apply_model(p, cfg, jnp.asarray(feats), jnp.asarray(inp), j_mask,
                                train=True, rng=jax.random.PRNGKey(0))
        return j_loss(out["logits"], jnp.asarray(tgt), 0, 0.1), out["logits"]

    (want_loss, want_logits), want = jax.value_and_grad(j_loss_fn, has_aux=True)(params)
    out = apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp),
                      torch.from_numpy(mask) if masked else None, train=True,
                      generator=torch.Generator().manual_seed(0))
    loss = label_smoothed_cross_entropy(out["logits"], torch.from_numpy(tgt), 0, 0.1)
    loss.backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = jax_params_from_state_dict({k: p.grad for k, p in model.named_parameters()}, pcfg)
    flat_want, flat_got = _leaves(want), _leaves(got)
    assert [p for p, _ in flat_want] == [p for p, _ in flat_got]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_want)
    for (path, w), (_, g) in zip(flat_want, flat_got):
        w, g = np.asarray(w), np.asarray(g)
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_dropout_sites_match_jax(tr_config, monkeypatch):
    """Each package's dropout, recorded by a patch in this test only: the
    same calls in the same order on tensors of the same shapes, 1 + 2 a
    block in the encoder and 1 + 3 a block in the decoder, at
    transformer_dropout, in training."""
    cfg = tr_config
    params, model, pcfg = _pair(cfg, seed=1)
    feats, mask, inp, _ = _batch(cfg)
    calls = {"jax": [], "port": []}

    def recorder(name):
        def rec(x, rate, key_or_gen, train):
            calls[name].append((tuple(x.shape), rate, bool(train)))
            return x
        return rec

    monkeypatch.setattr(j_tr, "dropout", recorder("jax"))
    monkeypatch.setattr(t_tr, "dropout", recorder("port"))
    j_cap.apply_model(params, cfg, jnp.asarray(feats), jnp.asarray(inp), jnp.asarray(mask),
                      train=True, rng=jax.random.PRNGKey(0))
    apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp),
                torch.from_numpy(mask), train=True, generator=torch.Generator().manual_seed(0))
    n_enc, n_dec = cfg.model.transformer_num_layers, cfg.model.transformer_decoder_layers
    assert len(calls["jax"]) == (1 + 2 * n_enc) + (1 + 3 * n_dec)
    assert calls["port"] == calls["jax"]
    assert all(rate == cfg.model.transformer_dropout and train
               for _, rate, train in calls["port"])


def test_dropout_is_the_identity_in_eval_mode(tr_config):
    """With a generator and rate 0.5, train=False gives the eval logits (equal
    to the JAX package's eval logits within 1e-5) and draws nothing."""
    cfg = tr_config
    cfg.model.transformer_dropout = 0.5
    params, model, pcfg = _pair(cfg, seed=2)
    feats, mask, inp, _ = _batch(cfg)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    with torch.no_grad():
        ev = apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp),
                         torch.from_numpy(mask), train=False, generator=g)["logits"]
        tr = apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp),
                         torch.from_numpy(mask), train=True,
                         generator=torch.Generator().manual_seed(3))["logits"]
    assert torch.equal(g.get_state(), state)
    want = j_cap.apply_model(params, cfg, jnp.asarray(feats), jnp.asarray(inp),
                             jnp.asarray(mask), train=False)["logits"]
    np.testing.assert_allclose(ev.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not torch.allclose(ev, tr)


def test_dropout_is_deterministic_from_a_seed(tr_config):
    cfg = tr_config
    cfg.model.transformer_dropout = 0.3
    _, model, pcfg = _pair(cfg, seed=2)
    feats, mask, inp, _ = _batch(cfg)

    def run(seed):
        with torch.no_grad():
            return apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp),
                               torch.from_numpy(mask), train=True,
                               generator=torch.Generator().manual_seed(seed))["logits"]

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture
def trained(tr_config, tmp_path, monkeypatch):
    """cli.train on the CPU: a tiny transformer on 4 captions, 16 clips (4
    seeded feature patterns with noise), 40 epochs."""
    from video_captioning_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)  # training.log and ensure_dirs() stay here
    cfg = port(tr_config)
    cfg.data.vocab_threshold = 1
    cfg.data.val_split = cfg.data.test_split = 0.1
    cfg.training.batch_size = 4
    cfg.training.learning_rate = 1e-2
    cfg.training.label_smoothing = 0.0
    cfg.training.num_workers = 1
    cfg.training.val_every_n_epochs = 10
    cfg.training.save_every_n_epochs = 100
    cfg.training.early_stopping_patience = 100
    cfg.experiment.use_tensorboard = False
    cfg.model.transformer_dropout = 0.1
    (tmp_path / "config.json").write_text(json.dumps(cfg.to_dict()))
    rs = np.random.RandomState(0)
    patterns = 3 * rs.randn(4, cfg.model.cnn_feature_dim).astype(np.float32)
    lines = ["video_id,video_path,feature_path,caption"]
    for i in range(20):
        feats = patterns[i % 4][None].repeat(cfg.data.frames_per_video, 0)
        feats = feats + 0.01 * rs.randn(*feats.shape).astype(np.float32)
        np.save(tmp_path / f"v{i}.npy", feats)
        lines.append(f"v{i},,{tmp_path / f'v{i}.npy'},{CAPTIONS[i % 4]}")
    (tmp_path / "captions.csv").write_text("\n".join(lines) + "\n")
    trainer = train.main(["--config", "config.json", "--data-file", "captions.csv",
                          "--checkpoint-dir", "ckpt", "--epochs", "40", "--device", "cpu",
                          "--log-level", "WARNING"])
    feats = [np.load(tmp_path / f"v{i}.npy") for i in range(4)]
    return trainer, tmp_path / "ckpt" / "model_for_inference.pth", feats


def test_tiny_transformer_memorizes_its_captions(trained):
    trainer, pkg, feats = trained
    history = [h["loss"] for h in trainer.train_history]
    assert history[-1] < 0.1 * history[0]
    got = VideoCaptionPredictor(pkg, device="cpu").predict_batch(feats, method="greedy")
    assert [r["caption"] for r in got] == CAPTIONS


def test_port_trained_package_serves_identical_beam_tokens_in_jax(trained):
    _, pkg, feats = trained
    want = JaxPredictor(pkg).predict_batch(feats, method="beam", beam_size=3)
    got = VideoCaptionPredictor(pkg, device="cpu").predict_batch(feats, method="beam",
                                                                 beam_size=3)
    assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want]
    assert [r["caption"] for r in got] == [r["caption"] for r in want]
