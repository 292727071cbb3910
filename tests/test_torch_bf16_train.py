"""bfloat16 training (``training.compute_dtype="bfloat16"``) in the port
against the JAX trainer's cast policy on the CPU (float32 master
parameters cast to bfloat16 inside the loss, features cast to bfloat16,
the loss reduced in float32), dropout off on both sides: one step's loss
within 1e-2 relative of ``jax.value_and_grad``'s and every gradient within
2e-2 of the largest gradient value, for both families; the host cast of
the features (bfloat16 training under a fused decode-step flag is in
tests/test_torch_bf16_fused.py); and a
two-epoch ``cli.train --compute-dtype bfloat16`` run whose package the JAX
predictor loads. The JAX encoder runs its Pallas recurrence in interpret
mode (``kernels.interpret``), the contract of the port's plain
``lstm_seq_train``."""

import json
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.config import Config
from video_captioning_tpu.inference import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.training.losses import label_smoothed_cross_entropy as j_loss
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data.pipeline import place_batch
from video_captioning_tpu_torch.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer

VOCAB = 50
LOSS_RTOL = 1e-2
# Every gradient's max error, over the largest gradient value of the step.
# Held over each gradient's own largest value it fails where bfloat16 does
# not resolve the gradient at all: at these sizes the JAX package's own
# bfloat16 gradients of the attention's small parameters (and the key
# biases, zero by softmax symmetry) are up to 47% of their largest value
# away from its float32 ones. Those per-gradient errors are printed.
GRAD_RTOL = 2e-2
FUSED_FLAGS = ("use_pallas_lstm", "use_pallas_attention", "use_fused_vocab_topk")


def _config(arch="lstm"):
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 64, 32, 32
    m.embedding_dim, m.attention_dim, m.attention_num_heads = 32, 32, 4
    m.max_sequence_length, m.video_sequence_length = 8, 10
    m.encoder_dropout = m.decoder_dropout = m.transformer_dropout = 0.0
    m.architecture = arch
    if arch == "transformer":
        m.transformer_num_layers = m.transformer_decoder_layers = 2
        m.transformer_num_heads = 4
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.training.compute_dtype = "bfloat16"
    cfg.training.batch_size = 4
    cfg.kernels.interpret = True  # the Pallas recurrence's contract, as the port's plain version
    cfg.validate()
    return cfg


def _port(cfg, tmp_path):
    pcfg = PortConfig.from_dict(cfg.to_dict())
    pcfg.experiment.checkpoint_dir = Path(tmp_path)
    pcfg.experiment.use_tensorboard = False
    return pcfg


def _batch(cfg, B=4, seed=4):
    rs = np.random.RandomState(seed)
    T = cfg.model.max_sequence_length
    tgt = rs.randint(1, VOCAB, (B, T)).astype(np.int32)
    tgt[0, 5:] = 0
    return {"video_features": rs.randn(B, 10, cfg.model.cnn_feature_dim).astype(np.float32),
            "input_tokens": rs.randint(0, VOCAB, (B, T)).astype(np.int32),
            "target_tokens": tgt}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _jax_cast_policy_step(cfg, params, batch):
    """The JAX trainer's loss_fn (training/trainer.py, _build_steps) under
    compute_dtype bfloat16: every float32 leaf cast inside the loss."""
    def cast(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, tree)

    def loss_fn(p):
        out = j_cap.apply_model(cast(p), cfg,
                                jnp.asarray(batch["video_features"]).astype(jnp.bfloat16),
                                jnp.asarray(batch["input_tokens"]), train=True, rng=None)
        return j_loss(out["logits"], jnp.asarray(batch["target_tokens"]), 0,
                      cfg.training.label_smoothing)

    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_bf16_step_matches_jax_cast_policy(arch, tmp_path):
    cfg = _config(arch)
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(1), cfg, VOCAB))
    batch = _batch(cfg)
    want_loss, want = _jax_cast_policy_step(cfg, params, batch)
    pcfg = _port(cfg, tmp_path)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    trainer = VideoCaptioningTrainer(model, pcfg, Vocabulary(pcfg), None, None, device="cpu")
    trainer.generator = None  # dropout off (the attention's too), as rng=None in JAX
    b = trainer._place(batch)
    assert b["video_features"].dtype == torch.bfloat16
    with trainer.compute_weights():
        assert trainer.model.decoder.output_projection.weight.dtype == torch.bfloat16
        loss = trainer._loss(trainer.model, b["video_features"], b["input_tokens"],
                             b["target_tokens"], train=True)
        assert loss.dtype == torch.float32
        loss.backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in trainer.model.parameters())
    loss_rel = abs(loss.item() - float(want_loss)) / abs(float(want_loss))
    got = jax_params_from_state_dict({k: p.grad for k, p in trainer.model.named_parameters()},
                                     pcfg)
    flat_want, flat_got = _leaves(want), _leaves(got)
    assert [p for p, _ in flat_want] == [p for p, _ in flat_got]
    top = max(float(np.abs(np.asarray(w, np.float32)).max()) for _, w in flat_want)
    errs, own = {}, {}
    for (path, w), (_, g) in zip(flat_want, flat_got):
        w, name = np.asarray(w, np.float32), jax.tree_util.keystr(path)
        errs[name] = float(np.abs(g - w).max()) / top
        own[name] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
    worst, worst_own = max(errs, key=errs.get), max(own, key=own.get)
    print(f"bf16 step {arch}: loss {loss.item():.6f} vs {float(want_loss):.6f} (rel "
          f"{loss_rel:.3g}); worst gradient {worst} {errs[worst]:.3g} of the largest "
          f"gradient value; worst over its own largest value {worst_own} {own[worst_own]:.3g}")
    assert loss_rel <= LOSS_RTOL
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_host_cast_equals_a_device_cast():
    """place_batch casts the features on the host: the values equal a cast
    after the copy and the JAX trainer's ml_dtypes cast (round to nearest
    even, subnormals and the largest finite values included)."""
    rs = np.random.RandomState(0)
    feats = (rs.randn(3, 10, 64) * np.exp(rs.uniform(-40, 40, (3, 10, 64)))).astype(np.float32)
    feats[0, 0, :4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 3.3895e38, 1e-40]
    batch = {"video_features": feats, "input_tokens": np.zeros((3, 8), np.int32),
             "video_id": ["a", "b", "c"]}
    placed = place_batch(batch, torch.device("cpu"), torch.bfloat16)
    assert set(placed) == {"video_features", "input_tokens"}
    assert placed["video_features"].dtype == torch.bfloat16
    assert placed["input_tokens"].dtype == torch.int32
    on_device = torch.from_numpy(feats).to("cpu").to(torch.bfloat16)
    assert torch.equal(placed["video_features"].view(torch.int16), on_device.view(torch.int16))
    want = feats.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(placed["video_features"].view(torch.int16).numpy(), want)
    f32 = place_batch(batch, torch.device("cpu"))
    assert f32["video_features"].dtype == torch.float32


CAPTIONS = ["a man is running fast", "a dog is barking loud", "a cat is sleeping now",
            "a bird is flying high"]


def test_cli_train_bf16_two_epochs_package_loads_in_jax(tmp_path, monkeypatch):
    from video_captioning_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)
    cfg = _config()
    rs = np.random.RandomState(0)
    lines = ["video_id,video_path,feature_path,caption"]
    for i in range(20):
        path = tmp_path / f"v{i}.npy"
        np.save(path, rs.randn(10, 64).astype(np.float32))
        lines.append(f"v{i},,{path},{CAPTIONS[i % 4]}")
    (tmp_path / "captions.csv").write_text("\n".join(lines) + "\n")
    pcfg = _port(cfg, tmp_path / "ckpt")
    (tmp_path / "config.json").write_text(json.dumps(pcfg.to_dict()))
    trainer = train.main(["--config", "config.json", "--data-file", "captions.csv",
                          "--checkpoint-dir", "ckpt", "--epochs", "2", "--device", "cpu",
                          "--compute-dtype", "bfloat16", "--log-level", "WARNING"])
    assert trainer.compute_dtype == torch.bfloat16
    results = json.loads((tmp_path / "ckpt" / "training_results.json").read_text())
    losses = [h["loss"] for h in results["train_history"] + results["val_history"]]
    assert len(results["train_history"]) == 2 and all(np.isfinite(losses))
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    pkg = tmp_path / "ckpt" / "model_for_inference.pth"
    feats = [np.load(tmp_path / f"v{i}.npy") for i in range(3)]
    want = JaxPredictor(pkg).predict_batch(feats, method="greedy")
    got = VideoCaptionPredictor(pkg, device="cpu").predict_batch(feats, method="greedy")
    assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want]
