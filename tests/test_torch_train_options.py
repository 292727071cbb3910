"""The trainer's remaining options in the port on the CPU: the
``experiment.profile_dir`` trace of epoch 0, Weights & Biases (absent: a
warning and training goes on; a stand-in module: the JAX trainer's calls
and keys), and resuming a training checkpoint that the JAX trainer wrote
(Adam, AdamW and SGD with gradient clipping, and with ``freeze_encoder``):
the port's third step from the JAX file equals the JAX trainer's within
1e-5 for the parameters and 1e-6 for the optimizer moments. A class of the
JAX stack outside the trainer's optax states is refused."""

import json
import logging
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from video_captioning_tpu.models import attention as j_attention
from video_captioning_tpu.models import init_model
from video_captioning_tpu.parallel import make_mesh
from video_captioning_tpu.training import VideoCaptioningTrainer as JaxTrainer
from video_captioning_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data.pipeline import create_data_loaders
from video_captioning_tpu_torch.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.utils.checkpoint import CheckpointManager, OptaxState

CAPTIONS = ["a man is running", "a dog is barking", "a cat is sleeping", "a bird is flying"]
PARAM_ATOL = 1e-5
MOMENT_ATOL = 1e-6
SCORE_BIAS = "['decoder']['attention']['attention_linear']['bias']"


def _config(tiny_config, tmp_path, **training):
    cfg = tiny_config
    cfg.data.vocab_threshold = 1
    cfg.model.encoder_dropout = cfg.model.decoder_dropout = 0.0
    cfg.training.batch_size = 4
    cfg.training.num_epochs = 2
    cfg.training.num_workers = 1
    cfg.training.gradient_clip_norm = 5.0
    cfg.training.learning_rate = 1e-2
    cfg.experiment.checkpoint_dir = Path(tmp_path) / "ckpt"
    cfg.experiment.use_tensorboard = False
    cfg.experiment.log_every_n_steps = 1
    for k, v in training.items():
        setattr(cfg.training, k, v)
    cfg.validate()
    return cfg


def _port_trainer(cfg, tmp_path, n=16):
    pcfg = PortConfig.from_dict(cfg.to_dict())
    vocab = Vocabulary(pcfg)
    vocab.build_vocabulary(CAPTIONS)
    rs = np.random.RandomState(0)
    rows = []
    for i in range(n):
        path = Path(tmp_path) / f"v{i}.npy"
        np.save(path, rs.randn(10, pcfg.model.cnn_feature_dim).astype(np.float32))
        rows.append({"video_id": f"v{i}", "video_path": "", "feature_path": str(path),
                     "caption": CAPTIONS[i % 4]})
    train, val, _ = create_data_loaders(pcfg, vocab, rows[:12], rows[12:])
    model = VideoCaptioningModel(pcfg, len(vocab))
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(0), cfg, len(vocab)))
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return VideoCaptioningTrainer(model, pcfg, vocab, train, val, device="cpu")


# ------------------------------------------------------------ profile_dir


def test_profile_dir_writes_a_trace_of_epoch_0(tiny_config, tmp_path):
    cfg = _config(tiny_config, tmp_path)
    cfg.experiment.profile_dir = tmp_path / "prof"
    trainer = _port_trainer(cfg, tmp_path)
    trainer.train_epoch()  # 3 steps: the trace ends with the epoch
    trace = tmp_path / "prof" / "trace_epoch0.pt.trace.json"
    assert trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    trace.unlink()
    trainer.current_epoch = 1
    trainer.train_epoch()  # epoch 1 is not traced
    assert not trace.exists()


# ------------------------------------------------------------------ W&B


def test_wandb_absent_warns_and_training_goes_on(tiny_config, tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    cfg = _config(tiny_config, tmp_path)
    cfg.experiment.use_wandb = True
    with caplog.at_level(logging.WARNING):
        trainer = _port_trainer(cfg, tmp_path)
    assert trainer.use_wandb is False
    assert any("wandb unavailable" in r.getMessage() for r in caplog.records)
    results = trainer.train()
    assert len(results["train_history"]) == 2


def test_wandb_calls_have_the_jax_trainers_keys(tiny_config, tmp_path, monkeypatch):
    calls = []
    stand_in = types.ModuleType("wandb")
    stand_in.init = lambda **kw: calls.append(("init", kw))
    stand_in.log = lambda d: calls.append(("log", d))
    stand_in.finish = lambda: calls.append(("finish", None))
    monkeypatch.setitem(sys.modules, "wandb", stand_in)
    cfg = _config(tiny_config, tmp_path)
    cfg.experiment.use_wandb = True
    trainer = _port_trainer(cfg, tmp_path)
    trainer.train()
    kinds = [c[0] for c in calls]
    assert kinds[0] == "init" and kinds[-1] == "finish" and kinds.count("finish") == 1
    init = calls[0][1]
    assert init["project"] == cfg.experiment.project_name
    assert init["name"] == cfg.experiment.experiment_name
    assert init["config"] == trainer.config.to_dict()
    logs = [c[1] for c in calls if c[0] == "log"]
    batch_logs = [d for d in logs if "train/batch_loss" in d]
    epoch_logs = [d for d in logs if "train/epoch_loss" in d]
    assert len(batch_logs) == 2 * 3  # log_every_n_steps=1, 3 steps an epoch
    assert all(set(d) == {"train/batch_loss", "train/learning_rate", "global_step"}
               for d in batch_logs)
    assert [d["global_step"] for d in batch_logs] == list(range(1, 7))
    assert [d["epoch"] for d in epoch_logs] == [0, 1]
    val_keys = {f"val/{k}" for k in trainer.val_history[0] if k not in ("loss", "epoch")}
    assert all(set(d) == {"train/epoch_loss", "val/epoch_loss", "epoch"} | val_keys
               for d in epoch_logs)


# --------------------------------------------------------------- resume


def _jax_batch(cfg, V, seed):
    rs = np.random.RandomState(seed)
    L = cfg.model.max_sequence_length
    tgt = rs.randint(1, V, (4, L)).astype(np.int32)
    tgt[1, 4:] = 0
    return {"video_features": rs.randn(4, 10, cfg.model.cnn_feature_dim).astype(np.float32),
            "input_tokens": rs.randint(0, V, (4, L)).astype(np.int32),
            "target_tokens": tgt}


def _jax_trainer(cfg):
    vocab = JaxVocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    params = init_model(jax.random.PRNGKey(0), cfg, len(vocab))
    return JaxTrainer(params, cfg, vocab, None, None, mesh=make_mesh(cfg, jax.devices()[:1]))


def _jax_step(trainer, batch):
    trainer._rng, rng = jax.random.split(trainer._rng)
    trainer.params, trainer.opt_state, loss = trainer._train_step(
        trainer.params, trainer.opt_state, trainer._place(batch), rng)
    trainer.global_step += 1
    return float(loss)


def _moments(cfg, optimizer, names, V):
    """The port optimizer's state as JAX-layout trees (zeros where a
    parameter is not trained)."""
    pcfg = PortConfig.from_dict(cfg.to_dict())
    model = VideoCaptioningModel(pcfg, V)
    full = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    keys = ("exp_avg", "exp_avg_sq") if "exp_avg" in optimizer.state[params[0]] else (
        "momentum_buffer",)
    return [jax_params_from_state_dict(dict(full, **{n: optimizer.state[p][k]
                                                     for n, p in zip(names, params)}), pcfg)
            for k in keys]


def _optax_moments(opt_state, kind):
    def find(s):
        if type(s).__name__ == kind:
            return s
        if isinstance(s, dict):
            s = list(s.values())
        if isinstance(s, (tuple, list)):
            for x in s:
                got = find(x)
                if got is not None:
                    return got
        return None

    st = find(opt_state)
    return [st.mu, st.nu] if kind == "ScaleByAdamState" else [st.trace]


@pytest.mark.parametrize("optimizer,freeze", [("adam", False), ("adamw", False), ("sgd", False),
                                              ("adam", True)])
def test_resume_from_a_jax_checkpoint_takes_the_jax_step(tiny_config, tmp_path, monkeypatch,
                                                         optimizer, freeze):
    # Dropout off on both sides: the zero rates, and the attention weights'
    # fixed rate patched to zero in JAX (the port's trainer gets no generator).
    monkeypatch.setattr(j_attention, "_ATTN_DROPOUT", 0.0)
    cfg = _config(tiny_config, tmp_path, optimizer=optimizer, freeze_encoder=freeze,
                  weight_decay=0.01)
    jt = _jax_trainer(cfg)
    V = len(jt.vocabulary)
    for step in range(2):
        _jax_step(jt, _jax_batch(cfg, V, seed=step))
    jt._save(1, {"train_loss": 1.0}, is_best=False)
    ckpt = Path(cfg.experiment.checkpoint_dir) / "checkpoint_epoch_0001.pth"

    # The JAX trainer's third step from the file.
    jt2 = _jax_trainer(cfg)
    jt2.load_checkpoint(ckpt)
    batch = _jax_batch(cfg, V, seed=2)
    _jax_step(jt2, batch)

    # The port's, from the same file.
    pcfg = PortConfig.from_dict(cfg.to_dict())
    vocab = Vocabulary(pcfg)
    vocab.build_vocabulary(CAPTIONS)
    pt = VideoCaptioningTrainer(VideoCaptioningModel(pcfg, V), pcfg, vocab, None, None,
                                device="cpu")
    pt.generator = None
    checkpoint = pt.load_checkpoint(ckpt)
    assert isinstance(checkpoint["optimizer_state_dict"], (tuple, OptaxState))
    assert (pt.current_epoch, pt.global_step) == (1, 2)
    assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(cfg.training.learning_rate)
    pt.train_step(batch)

    want = jax.tree_util.tree_map(np.asarray, jt2.params)
    got = jax_params_from_state_dict(pt.model.state_dict(), pcfg)
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        name = jax.tree_util.keystr(path)
        # The score bias's gradient is zero by the softmax's shift
        # invariance, so both hold rounding noise there, and Adam's
        # normalized step turns that noise into a step of up to the
        # learning rate, of either sign.
        atol = (cfg.training.learning_rate if name == SCORE_BIAS and optimizer != "sgd"
                else PARAM_ATOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    kind = "TraceState" if optimizer == "sgd" else "ScaleByAdamState"
    for want_m, got_m in zip(_optax_moments(jt2.opt_state, kind),
                             _moments(cfg, pt.optimizer, pt.trainable_names, V)):
        for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want_m)[0],
                                     jax.tree_util.tree_flatten_with_path(got_m)[0]):
            if freeze and jax.tree_util.keystr(path).startswith("['encoder']"):
                continue  # the frozen encoder has no moments (MaskedNode in optax)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=MOMENT_ATOL,
                                       err_msg=jax.tree_util.keystr(path))
    if freeze:
        assert not any(n.startswith("encoder.") for n in pt.trainable_names)


def test_resume_refuses_a_class_outside_the_trainers_optax_states(tiny_config, tmp_path):
    import optax

    params = init_model(jax.random.PRNGKey(0), tiny_config, 17)
    JaxCheckpointManager(tmp_path).save_checkpoint(
        params, optax.lion(1e-3).init(params), 0, {}, config=tiny_config)
    with pytest.raises(ValueError, match="ScaleByLionState.*written by the JAX package"):
        CheckpointManager(tmp_path).load_checkpoint(tmp_path / "checkpoint_epoch_0000.pth")

    class Evil:
        def __reduce__(self):
            return (jnp.zeros, ((2,),))

    (tmp_path / "evil.pth").write_bytes(pickle.dumps({"optimizer_state_dict": Evil()}))
    with pytest.raises(ValueError, match="written by the JAX package"):
        CheckpointManager(tmp_path).load_checkpoint(tmp_path / "evil.pth")
