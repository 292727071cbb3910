"""The ``checkpoint_backend="orbax"`` backend of the port on
``torch.distributed.checkpoint`` (``utils/orbax_ckpt.py``), mirroring
tests/test_orbax_ckpt.py: a save/restore round trip, keep-last-N, a
missing epoch raising, the trainer's resume restoring the parameters and
the optimizer state exactly, a changed optimizer refused, the best
epoch's snapshot surviving later training, ``cli.train`` over two epochs
resumed once, and a JAX-written orbax directory refused with a message
that names orbax and tensorstore."""

import copy
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from video_captioning_tpu.models import init_model
from video_captioning_tpu.training import optim as j_optim
from video_captioning_tpu.utils.orbax_ckpt import OrbaxCheckpointManager as JaxOrbaxManager
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data.pipeline import create_data_loaders
from video_captioning_tpu_torch.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.utils.orbax_ckpt import OrbaxCheckpointManager

CAPTIONS = ["a man runs", "a dog barks", "a cat sleeps", "a bird flies"]


def _cfg(tiny_config, tmp_path, **training):
    cfg = PortConfig.from_dict(tiny_config.to_dict())
    cfg.data.vocab_threshold = 1
    cfg.training.batch_size = 4
    cfg.training.num_workers = 1
    for k, v in training.items():
        setattr(cfg.training, k, v)
    cfg.experiment.checkpoint_dir = Path(tmp_path) / "ck"
    cfg.experiment.checkpoint_backend = "orbax"
    cfg.experiment.use_tensorboard = False
    cfg.validate()
    return cfg


def _rows(tmp_path, cfg, n=8):
    rs = np.random.RandomState(0)
    rows = []
    for i in range(n):
        p = Path(tmp_path) / f"v{i}.npy"
        np.save(p, rs.randn(10, cfg.model.cnn_feature_dim).astype(np.float32))
        rows.append({"video_id": f"v{i}", "video_path": "", "feature_path": str(p),
                     "caption": CAPTIONS[i % 4]})
    return rows


def _trainer(tiny_config, tmp_path, seed=0, cfg=None, **training):
    cfg = cfg or _cfg(tiny_config, tmp_path, **training)
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    rows = _rows(tmp_path, cfg)
    tr, va, _ = create_data_loaders(cfg, vocab, rows[:4], rows[4:])
    params = init_model(jax.random.PRNGKey(seed), tiny_config, len(vocab))
    model = VideoCaptioningModel(cfg, len(vocab))
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return VideoCaptioningTrainer(model, cfg, vocab, tr, va, device="cpu")


def test_save_restore_roundtrip(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    mgr = OrbaxCheckpointManager(tmp_path / "orbax")
    mgr.save(3, model.state_dict(), opt.state_dict(), metrics={"bleu_4": 0.25},
             extra={"global_step": 99})
    mgr.wait()
    restored = mgr.restore()
    assert restored["meta"]["epoch"] == 3 and restored["meta"]["global_step"] == 99
    assert restored["metrics"]["bleu_4"] == 0.25
    for k, v in model.state_dict().items():
        assert torch.equal(restored["params"][k], v)
    opt2 = torch.optim.Adam(torch.nn.Linear(3, 2).parameters())
    opt2.load_state_dict(restored["opt_state"])  # usable
    for a, b in zip(opt.state_dict()["state"].values(), opt2.state_dict()["state"].values()):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_keep_last_n(tmp_path):
    mgr = OrbaxCheckpointManager(tmp_path / "orbax", keep_last=3)
    for epoch in range(6):
        mgr.save(epoch, {"w": torch.ones(2, 2) * epoch}, {"state": {}, "param_groups": []})
    mgr.wait()
    assert mgr.all_epochs() == [3, 4, 5] and mgr.latest_epoch() == 5
    assert torch.equal(mgr.restore(4)["params"]["w"], torch.full((2, 2), 4.0))
    mgr.close()


def test_restore_missing_raises(tmp_path):
    mgr = OrbaxCheckpointManager(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(1, {"w": torch.ones(1)}, {"state": {}, "param_groups": []})
    with pytest.raises(FileNotFoundError, match="epoch 7"):
        mgr.restore(7)


def test_trainer_orbax_roundtrip_and_exact_optimizer_state(tiny_config, tmp_path):
    trainer = _trainer(tiny_config, tmp_path)
    trainer.train_epoch()  # Adam moments now non-trivial
    trainer.global_step = 7
    trainer.best_val_score = 0.5
    trainer._save(epoch=2, metrics={"bleu_4": 0.5}, is_best=True)
    trainer.orbax_manager.wait()
    want_opt = trainer.optimizer.state_dict()

    trainer2 = _trainer(tiny_config, tmp_path, seed=9)
    trainer2.load_orbax_checkpoint()
    assert (trainer2.current_epoch, trainer2.global_step, trainer2.best_val_score) == (2, 7, 0.5)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(trainer2.model.state_dict()[k], v), k
    got_opt = trainer2.optimizer.state_dict()
    assert len(want_opt["state"]) == len(got_opt["state"])
    for i, entry in want_opt["state"].items():
        for key, value in entry.items():
            assert torch.equal(got_opt["state"][i][key], value), (i, key)
    assert got_opt["param_groups"][0]["lr"] == want_opt["param_groups"][0]["lr"] > 0
    # The next step from either trainer is the same step.
    batch = next(iter(trainer.train_loader))
    trainer.generator = trainer2.generator = None
    assert torch.equal(trainer.train_step(batch), trainer2.train_step(batch))


def test_orbax_resume_rejects_changed_optimizer(tiny_config, tmp_path):
    trainer = _trainer(tiny_config, tmp_path)
    trainer._save(epoch=1, metrics={}, is_best=False)
    trainer.orbax_manager.wait()
    cfg2 = copy.deepcopy(trainer.config)
    cfg2.training.freeze_encoder = True  # a different optimizer partition
    trainer2 = _trainer(tiny_config, tmp_path, seed=1, cfg=cfg2)
    with pytest.raises(ValueError, match="optimizer"):
        trainer2.load_orbax_checkpoint()
    trainer3 = _trainer(tiny_config, tmp_path, seed=2)
    trainer3.load_orbax_checkpoint()
    assert trainer3.current_epoch == 1


def test_orbax_best_snapshot_survives_later_training(tiny_config, tmp_path):
    trainer = _trainer(tiny_config, tmp_path)
    assert trainer.best_eval_state is None
    trainer._save(epoch=0, metrics={"bleu_4": 0.5}, is_best=True)
    best = {k: v.clone() for k, v in trainer.best_eval_state.items()}
    trainer.train_epoch()
    assert any(not torch.equal(best[k], v) for k, v in trainer.eval_state_dict().items())
    trainer._save(epoch=1, metrics={"bleu_4": 0.1}, is_best=False)
    for k, v in best.items():
        assert torch.equal(trainer.best_eval_state[k], v), k
    trainer.orbax_manager.wait()


def test_jax_orbax_directory_refused(tiny_config, tmp_path):
    params = init_model(jax.random.PRNGKey(0), tiny_config, 13)
    tx = j_optim.build_optimizer(tiny_config)
    jmgr = JaxOrbaxManager(tmp_path / "orbax")
    jmgr.save(3, params, tx.init(params), metrics={"bleu_4": 0.25})
    jmgr.wait()
    jmgr.close()
    with pytest.raises(ValueError, match="orbax and tensorstore"):
        OrbaxCheckpointManager(tmp_path / "orbax").restore()


def test_cli_train_orbax_two_epochs_then_resume(tiny_config, tmp_path, monkeypatch):
    """``cli.train --checkpoint-backend orbax`` for two epochs writes the
    epochs' directories and a package from the best snapshot; a second run
    resumed from epoch 1's directory continues from its parameters and
    optimizer state."""
    from video_captioning_tpu_torch.cli import train as train_cli

    cfg = _cfg(tiny_config, tmp_path)
    cfg.training.num_epochs = 2
    cfg.training.save_every_n_epochs = 1
    rows = _rows(tmp_path, cfg, n=20)
    csv_path = tmp_path / "data.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    cfg_path = tmp_path / "cfg.json"
    d = cfg.to_dict()
    import json

    cfg_path.write_text(json.dumps(d, default=str))
    monkeypatch.chdir(tmp_path)
    args = ["--data-file", str(csv_path), "--config", str(cfg_path), "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-backend", "orbax",
            "--no-tensorboard", "--log-level", "WARNING"]
    trainer = train_cli.main(args)
    orbax_dir = tmp_path / "ck" / "orbax"
    assert trainer.orbax_manager.all_epochs() == [0, 1]
    assert (tmp_path / "ck" / "model_for_inference.pth").exists()
    assert not (tmp_path / "ck" / "best_model.pth").exists()
    saved = trainer.orbax_manager.restore(1)
    resumed = train_cli.main(args + ["--resume", str(orbax_dir / "1"), "--epochs", "3"])
    assert [h["epoch"] for h in resumed.train_history] == [1, 2]
    assert resumed.global_step > int(saved["meta"]["global_step"])
    with pytest.raises(ValueError, match="orbax and tensorstore"):
        (orbax_dir / "jax").mkdir()
        (orbax_dir / "jax" / "_CHECKPOINT_METADATA").write_text("{}")
        train_cli.main(args + ["--resume", str(orbax_dir / "jax")])
