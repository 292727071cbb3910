"""The port's ``cli.import_reference`` against the JAX package's on the CPU.
Synthetic upstream artifacts stand in for files the upstream project
writes: ``torch.save`` of the state dict ``state_dict_from_jax_params``
gives (the upstream parameter names) with an upstream-style config object
(its classes in ``src.config.config``, loaded through the unpickle stubs)
and vocabulary: an inference package, a training checkpoint with
``--vocabulary`` and a raw state dict with ``--vocabulary`` and
``--config``. Both ``migrate`` functions must write equal parameters,
configs and vocabularies, and the port's package must serve the JAX
package's greedy tokens."""

import json
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from video_captioning_tpu.cli import import_reference as j_ir
from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import init_model
from video_captioning_tpu_torch.cli import import_reference as t_ir
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params

CAPTIONS = ["a man rides a horse", "a dog runs fast", "a cat sleeps"]
MODEL_FIELDS = dict(cnn_feature_dim=24, encoder_hidden_dim=16, decoder_hidden_dim=16,
                    embedding_dim=12, attention_dim=16, encoder_num_layers=2,
                    decoder_num_layers=2, max_sequence_length=8, video_sequence_length=10)


def _upstream_config_module():
    """A stand-in for the upstream ``src.config.config`` module, so that
    pickled config objects name it as the upstream files do."""
    mod = types.ModuleType("src.config.config")
    for name in ("Config", "ModelConfig", "DataConfig", "TrainingConfig", "Device"):
        setattr(mod, name, type(name, (), {"__module__": "src.config.config"}))
    return mod


def _upstream_config(mod, vocab_size):
    cfg = mod.Config()
    cfg.model = mod.ModelConfig()
    cfg.model.__dict__.update(MODEL_FIELDS, dropout=0.3)
    cfg.data = mod.DataConfig()
    cfg.data.__dict__.update(frames_per_video=10, max_vocab_size=vocab_size, vocab_threshold=1,
                             pin_memory=True)  # an upstream-only field
    cfg.training = mod.TrainingConfig()
    cfg.training.__dict__.update(batch_size=16, learning_rate=2e-4, device=mod.Device())
    return cfg


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """The three kinds of upstream file, a vocabulary.json and a base
    config for the raw state dict; the upstream module is registered only
    while they are written."""
    tmp = tmp_path_factory.mktemp("upstream")
    cfg = Config()
    for k, v in MODEL_FIELDS.items():
        setattr(cfg.model, k, v)
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    vocab.save(tmp / "vocabulary.json")
    cfg.data.max_vocab_size = len(vocab)
    (tmp / "base.json").write_text(json.dumps(cfg.to_dict()))
    params = jax.tree_util.tree_map(np.asarray,
                                    init_model(jax.random.PRNGKey(4), cfg, len(vocab)))
    params["decoder"]["output_projection"]["kernel"] = \
        params["decoder"]["output_projection"]["kernel"] * 3.0
    state = state_dict_from_jax_params(params, PortConfig.from_dict(cfg.to_dict()))
    vocab_dict = {"word2idx": vocab.word2idx, "idx2word": vocab.idx2word,
                  "special_tokens": {"pad_token": vocab.pad_token, "pad_idx": vocab.pad_idx,
                                     "start_token": vocab.start_token,
                                     "start_idx": vocab.start_idx,
                                     "end_token": vocab.end_token, "end_idx": vocab.end_idx,
                                     "unk_token": vocab.unk_token, "unk_idx": vocab.unk_idx}}
    mod = _upstream_config_module()
    names = ("src", "src.config", "src.config.config")
    assert not any(n in sys.modules for n in names)
    sys.modules.update({"src": types.ModuleType("src"),
                        "src.config": types.ModuleType("src.config"), "src.config.config": mod})
    try:
        ref_cfg = _upstream_config(mod, len(vocab))
        torch.save({"model_state_dict": state, "model_config": ref_cfg, "vocabulary": vocab_dict,
                    "model_info": {"vocab_size": len(vocab)}}, tmp / "package.pth")
        torch.save({"epoch": 3, "model_state_dict": state, "optimizer_state_dict": {},
                    "config": ref_cfg}, tmp / "checkpoint.pth")
        torch.save(state, tmp / "state.pth")
    finally:
        for n in names:
            sys.modules.pop(n, None)
    return tmp


KINDS = {
    "inference_package": ("package.pth", False, False),
    "training_checkpoint": ("checkpoint.pth", True, False),
    "state_dict": ("state.pth", True, True),
}


def _migrate(module, cfg_cls, upstream, kind, out):
    name, with_vocab, with_config = KINDS[kind]
    return module.migrate(upstream / name, out,
                          vocabulary_path=upstream / "vocabulary.json" if with_vocab else None,
                          base_config=cfg_cls.from_file(upstream / "base.json")
                          if with_config else None)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("kind", list(KINDS))
def test_migrate_writes_the_jax_package(upstream, tmp_path, kind):
    want_sum = _migrate(j_ir, Config, upstream, kind, tmp_path / "jax")
    got_sum = _migrate(t_ir, PortConfig, upstream, kind, tmp_path / "port")
    assert got_sum["source_kind"] == want_sum["source_kind"] == kind
    for key in ("vocab_size", "attention_type", "parameters"):
        assert got_sum[key] == want_sum[key], key
    want, got = _load(want_sum["output"]), _load(got_sum["output"])
    assert got["model_config"] == want["model_config"]
    assert got["model_config"]["model"]["cnn_feature_dim"] == 24
    assert got["vocabulary"] == want["vocabulary"] and got["model_info"] == want["model_info"]
    flat_w = jax.tree_util.tree_flatten_with_path(want["model_state_dict"])[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got["model_state_dict"])[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32, path
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    assert (json.loads(Path(got_sum["vocabulary"]).read_text())
            == json.loads(Path(want_sum["vocabulary"]).read_text()))
    # The upstream module stubs are gone once the file is loaded.
    assert "src.config.config" not in sys.modules


def test_migrated_package_serves_the_jax_greedy_tokens(upstream, tmp_path):
    pkg_j = _migrate(j_ir, Config, upstream, "inference_package", tmp_path / "jax")["output"]
    pkg_t = t_ir.main(["--input", str(upstream / "package.pth"), "--output-dir",
                       str(tmp_path / "port"), "--log-level", "WARNING"])["output"]
    feats = [np.random.RandomState(i).randn(10, 24).astype(np.float32) for i in range(3)]
    want = JaxPredictor(Path(pkg_j)).predict_batch(feats, method="greedy")
    got = VideoCaptionPredictor(pkg_t, device="cpu").predict_batch(feats, method="greedy")
    assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want]
    assert [r["caption"] for r in got] == [r["caption"] for r in want]


def test_migrate_refuses_what_it_cannot_convert(upstream, tmp_path):
    with pytest.raises(SystemExit, match="--vocabulary"):
        t_ir.migrate(upstream / "checkpoint.pth", tmp_path)
    torch.save({"weights": torch.zeros(2)}, tmp_path / "other.pth")
    with pytest.raises(SystemExit, match="upstream artifact"):
        t_ir.migrate(tmp_path / "other.pth", tmp_path)
