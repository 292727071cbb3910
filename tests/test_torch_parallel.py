"""Data, vocabulary and context parallelism in the port
(``video_captioning_tpu_torch/parallel/``), mirroring tests/test_parallel.py
and tests/test_multihost.py. Multi-rank cases run in spawned ``gloo``
processes on the CPU (``parallel.multihost.spawn_ranks``: a ``file://``
rendezvous under ``tmp_path``, a time limit per call), whose rank
functions are in tests/torch_parallel_workers.py and import no JAX.

Held: the sharding rules equal the JAX ``param_specs`` leaf for leaf
through the weight bridge; a 2- and a 4-rank data-parallel step and a
``model_axis = 2`` step equal the single-process step (loss 1e-6 relative,
parameters 1e-5: the ranks' gradient sum adds in another order than one
process's backward pass); context-parallel greedy and beam tokens equal
JAX's unsharded tokens for Bahdanau, Luong, multi-head and the
transformer; mesh serving equals single-device serving token for token;
``dryrun_multihost`` with 2 processes equals its replay bit for bit; and
the refusals the JAX package keeps."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import torch_parallel_workers as workers
from video_captioning_tpu import generation as j_generation
from video_captioning_tpu.models import init_model
from video_captioning_tpu.parallel import param_specs as j_param_specs
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data.vocabulary import Vocabulary as PortVocabulary
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import (
    init_params_numpy,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.parallel import (
    make_mesh,
    param_shardings,
    param_specs,
    replicated,
    shard_batch,
)
from video_captioning_tpu_torch.parallel.context_parallel import attend_context_parallel
from video_captioning_tpu_torch.parallel.mesh import Mesh, local_shard_info
from video_captioning_tpu_torch.parallel.multihost import dryrun_multihost, spawn_ranks
from video_captioning_tpu_torch.parallel.sharding import P
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.utils import checkpoint as port_ckpt

VOCAB = 32  # divisible by the model axis
TIMEOUT = 90.0


def port(cfg) -> PortConfig:
    return PortConfig.from_dict(cfg.to_dict())


def _transformer(cfg):
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim = cfg.model.decoder_hidden_dim
    cfg.model.transformer_num_heads = 4
    cfg.validate()
    return cfg


def _state(cfg, vocab=VOCAB, seed=0):
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(seed), cfg, vocab))
    return params, {k: v.numpy().copy()
                    for k, v in state_dict_from_jax_params(params, port(cfg)).items()}


def _batch(cfg, B=8):
    rs = np.random.RandomState(0)
    tgt = rs.randint(1, VOCAB, (B, 6)).astype(np.int32)
    tgt[1, 4:] = 0  # ragged: ranks hold different token counts
    tgt[6, 2:] = 0
    return {"video_features": rs.randn(B, 10, cfg.model.cnn_feature_dim).astype(np.float32),
            "input_tokens": rs.randint(0, VOCAB, (B, 6)).astype(np.int32),
            "target_tokens": tgt}


# ------------------------------------------------------------------ rules


@pytest.mark.parametrize("architecture", ["lstm", "transformer"])
def test_param_specs_match_jax_through_the_bridge(tiny_config, architecture):
    """Each torch parameter is tagged with its index; the bridge carries the
    tags to the JAX tree, so each JAX leaf names its torch parameter. A
    JAX spec that splits the vocabulary columns of a (H, V) kernel is the
    torch weight's rows."""
    cfg = _transformer(tiny_config) if architecture == "transformer" else tiny_config
    params, state = _state(cfg)
    pcfg = port(cfg)
    names = list(state)
    tagged = {n: torch.full(v.shape, float(i)) for i, (n, v) in enumerate(state.items())}
    tags = jax_params_from_state_dict(tagged, pcfg)
    want = j_param_specs(params)
    got = param_specs(state)
    flat_tags = jax.tree_util.tree_flatten_with_path(tags)[0]
    flat_want = dict((jax.tree_util.keystr(p), s) for p, s in
                     jax.tree_util.tree_flatten_with_path(
                         want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    split = 0
    for path, tag in flat_tags:
        key = jax.tree_util.keystr(path)
        name = names[int(np.asarray(tag).flat[0])]
        jspec = tuple(flat_want[key])
        tspec = tuple(got[name])
        if path[-1].key == "kernel" and jspec:
            jspec = tuple(reversed(jspec + (None,) * (2 - len(jspec))))
        assert tuple(a for a in jspec if a) == tuple(a for a in tspec if a), (key, name)
        assert (jspec and jspec[0]) == (tspec and tspec[0]), (key, name, jspec, tspec)
        split += bool(tspec)
    assert split == 3  # the table, the projection's weight and bias
    assert got["decoder.embedding.weight"] == P("model", None)
    assert got["decoder.output_projection.bias"] == P("model")
    assert all(got[n] == P() for n in names if n.startswith("encoder."))


def test_make_mesh_sizes_and_errors(tiny_config):
    cfg = port(tiny_config)
    mesh = make_mesh(cfg, ["cpu"] * 8)
    assert mesh.shape == {"data": 8, "model": 1} and mesh.coords == (0, 0)
    cfg.parallel.model_axis = 2
    assert make_mesh(cfg, ["cpu"] * 8).shape == {"data": 4, "model": 2}
    cfg.parallel.data_axis = 2
    assert make_mesh(cfg, ["cpu"] * 8).size == 4  # a subset of the devices
    cfg.parallel.model_axis = 3
    with pytest.raises(ValueError, match="not divisible by model_axis=3"):
        make_mesh(cfg, ["cpu"] * 8)
    cfg.parallel.model_axis, cfg.parallel.data_axis = 2, 8
    with pytest.raises(ValueError, match="mesh 8x2 needs 16 devices, have 8"):
        make_mesh(cfg, ["cpu"] * 8)
    assert local_shard_info(mesh) == (0, 1)
    assert replicated(mesh).spec == P()
    assert param_shardings(mesh, {"decoder.embedding.weight": 0})[
        "decoder.embedding.weight"].spec == P("model", None)


def test_make_mesh_without_devices_group_or_card_raises(tiny_config, monkeypatch):
    """With no devices, no process group and no card visible, make_mesh
    raises instead of building a CPU mesh; a CPU mesh is asked for by name."""
    cfg = port(tiny_config)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        make_mesh(cfg)
    mesh = make_mesh(cfg, ["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    assert list(mesh.devices.reshape(-1)) == [torch.device("cpu")]


def test_shard_batch_takes_each_data_index_its_block(tiny_config):
    cfg = port(tiny_config)
    mesh = make_mesh(cfg, ["cpu"] * 4)
    batch = _batch(tiny_config)
    blocks = [shard_batch(mesh, batch, i) for i in range(4)]
    np.testing.assert_array_equal(np.concatenate([b["input_tokens"] for b in blocks]),
                                  batch["input_tokens"])
    assert blocks[0]["video_features"].shape[0] == 2
    with pytest.raises(ValueError, match="does not split over the data axis"):
        shard_batch(make_mesh(cfg, ["cpu"] * 3), batch)


def test_vocabulary_split_collectives_match_unsplit_modules(tmp_path):
    """On a 2 x 2 gloo mesh: the vocabulary-parallel embedding and the
    column-parallel linear give the unsplit outputs, and their gradients
    are the unsplit gradients' blocks (the input's whole)."""
    results = spawn_ranks(workers.collectives, 4, timeout=TIMEOUT, workdir=tmp_path)
    table, w, b, tokens, x = results[0]["inputs"]
    emb = torch.nn.Embedding.from_pretrained(torch.from_numpy(table), freeze=False)
    lin = torch.nn.Linear(5, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    xr = torch.from_numpy(x).requires_grad_(True)
    y = lin(xr)
    (y * torch.arange(8.0)).sum().backward()
    e = emb(torch.from_numpy(tokens))
    (e * 2.0).sum().backward()
    assert sorted(r["coords"] for r in results) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in results:
        s = slice(r["start"], r["start"] + 4)
        np.testing.assert_allclose(r["emb"], e.detach().numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["lin"], y.detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["x_grad"], xr.grad.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["w_grad"], lin.weight.grad.numpy()[s], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["table_grad"], emb.weight.grad.numpy()[s], rtol=0, atol=0)


# ----------------------------------------------------------- training step


def _single_process_step(cfg, state, batch, tmp_path):
    pcfg = port(cfg)
    pcfg.experiment.checkpoint_dir = tmp_path / "single"
    pcfg.experiment.use_tensorboard = False
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    trainer = VideoCaptioningTrainer(model, pcfg, PortVocabulary(pcfg), None, None, device="cpu")
    trainer.generator = None
    loss = trainer.train_step(batch)
    return float(loss), {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}


@pytest.mark.parametrize("world, model_axis", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_data_parallel_step_equals_the_single_process_step(tiny_config, tmp_path, world,
                                                           model_axis):
    """Every rank reports the global loss; rank 0's checkpoint holds the
    unsplit parameters, loadable by the JAX package's layout."""
    cfg = tiny_config
    cfg.data.max_vocab_size = VOCAB
    cfg.validate()
    _, state = _state(cfg)
    batch = _batch(cfg)
    want_loss, want = _single_process_step(cfg, state, batch, tmp_path)
    results = spawn_ranks(workers.train_step, world,
                          (port(cfg).to_dict(), state, batch, model_axis, tmp_path / "ckpt"),
                          timeout=TIMEOUT, workdir=tmp_path / "ranks")
    data = world // model_axis
    assert {r["rows"] for r in results} == {8 // data}
    assert {r["local_vocab_rows"] for r in results} == {VOCAB // model_axis}
    for r in results:
        assert abs(r["loss"] - want_loss) <= 1e-6 * abs(want_loss), (r["loss"], want_loss)
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    saved = port_ckpt.CheckpointManager(tmp_path / "ckpt").load_checkpoint(
        tmp_path / "ckpt" / "checkpoint_epoch_0000.pth")
    table = np.asarray(saved["model_state_dict"]["decoder"]["embedding"]["table"])
    np.testing.assert_allclose(table, results[0]["params"]["decoder.embedding.weight"],
                               rtol=0, atol=0)


def test_cli_train_on_two_ranks(tiny_config, tmp_path):
    """``cli.train`` in a 2-rank gloo group (the ``torchrun`` launch): each
    rank reads half the rows at half the batch, both end with the same
    parameters, and rank 0 alone writes the checkpoints and the package."""
    import csv
    import json

    cfg = port(tiny_config)
    cfg.data.vocab_threshold = 1
    cfg.training.batch_size, cfg.training.num_epochs, cfg.training.num_workers = 4, 2, 1
    rs = np.random.RandomState(0)
    with open(tmp_path / "data.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["video_id", "video_path", "feature_path", "caption"])
        for i in range(40):
            np.save(tmp_path / f"v{i}.npy", rs.randn(10, 24).astype(np.float32))
            writer.writerow([f"v{i}", "", str(tmp_path / f"v{i}.npy"),
                             ["a man runs", "a dog barks", "a cat sleeps"][i % 3]])
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict(), default=str))
    args = ["--data-file", str(tmp_path / "data.csv"), "--config", str(tmp_path / "cfg.json"),
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"), "--no-tensorboard",
            "--log-level", "WARNING"]
    results = spawn_ranks(workers.cli_train, 2, (args, str(tmp_path)), timeout=TIMEOUT,
                          workdir=tmp_path / "ranks")
    assert [r["batch"] for r in results] == [2, 2]
    assert results[0]["steps"] == results[1]["steps"] > 0
    for k, v in results[0]["params"].items():
        np.testing.assert_array_equal(results[1]["params"][k], v, err_msg=k)
    for name in ("model_for_inference.pth", "latest_checkpoint.pth", "vocabulary.json",
                 "training_results.json"):
        assert (tmp_path / "ck" / name).exists(), name


# ---------------------------------------------------- context parallelism


@pytest.mark.parametrize("kind", ["bahdanau", "luong", "multihead", "transformer"])
def test_context_parallel_generation_matches_jax_unsharded(tiny_config, tmp_path, kind):
    """Four gloo ranks split the 16 frames; the ragged mask's tail crosses
    a shard boundary. Greedy and beam tokens equal the JAX package's
    unsharded tokens on every rank; the weights and scores agree to the
    order of the softmax sums."""
    cfg = tiny_config
    if kind == "transformer":
        _transformer(cfg)
    else:
        cfg.model.attention_type = kind
    cfg.model.video_sequence_length = 16
    cfg.data.frames_per_video = 16
    cfg.validate()
    params, state = _state(cfg, vocab=23)
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (4, 16, cfg.model.cnn_feature_dim)), np.float32)
    mask = np.ones((4, 16), np.float32)
    mask[2, 10:] = 0
    ref_g = j_generation.generate(params, cfg, feats, 1, 2, 6, video_mask=mask, method="greedy")
    ref_b = j_generation.generate(params, cfg, feats, 1, 2, 6, video_mask=mask, method="beam",
                                  beam_size=4)
    results = spawn_ranks(workers.cp_generate, 4, (port(cfg).to_dict(), state, feats, mask, 4),
                          timeout=TIMEOUT, workdir=tmp_path)
    for r in results:
        np.testing.assert_array_equal(r["greedy"]["generated_tokens"],
                                      np.asarray(ref_g["generated_tokens"]))
        np.testing.assert_allclose(r["greedy"]["attention_weights"],
                                   np.asarray(ref_g["attention_weights"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["beam"]["generated_tokens"],
                                      np.asarray(ref_b["generated_tokens"]))
        np.testing.assert_allclose(r["beam"]["all_scores"], np.asarray(ref_b["all_scores"]),
                                   rtol=1e-4, atol=1e-5)


def test_context_parallel_attention_on_one_rank_equals_attend(tiny_config):
    """With a context axis of one rank (no process group) the frame-split
    path is the plain attention: the legacy Bahdanau entry equals
    ``attend`` exactly on a ragged mask."""
    from video_captioning_tpu_torch.models import attention as t_attn

    cfg = port(tiny_config)
    attn = t_attn.make_attention(cfg)
    g = torch.Generator().manual_seed(0)
    enc = torch.randn(4, 10, cfg.model.encoder_hidden_dim, generator=g)
    h = torch.randn(4, cfg.model.decoder_hidden_dim, generator=g)
    mask = torch.ones(4, 10)
    mask[1, 7:] = 0
    mesh = make_mesh(cfg, ["cpu"])
    with torch.no_grad():
        want = t_attn.attend(cfg, attn, t_attn.precompute(attn, enc), enc, h, mask)
        got = attend_context_parallel(cfg, attn, enc, h, mask, mesh, axis="model")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    luong = port(tiny_config)
    luong.model.attention_type = "luong"
    with pytest.raises(ValueError, match="bahdanau-only"):
        attend_context_parallel(luong, t_attn.make_attention(luong), enc, h, mask, mesh)


# --------------------------------------------------------------- serving


def _package(tmp_path, cfg):
    pcfg = port(cfg)
    pcfg.data.vocab_threshold = 1
    vocab = PortVocabulary(pcfg)
    vocab.build_vocabulary(["a man rides a horse", "a woman cooks food", "a dog runs fast"])
    return port_ckpt.save_model_for_inference(init_params_numpy(pcfg, len(vocab), seed=7),
                                              vocab, pcfg, tmp_path)


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("architecture", ["lstm", "transformer"])
def test_predictor_mesh_serving_matches_single_device(tiny_config, tmp_path, method,
                                                      architecture):
    """Four CPU replicas over a 5-clip ragged batch (padded to 8, two clips
    a replica) equal one device token for token."""
    cfg = _transformer(tiny_config) if architecture == "transformer" else tiny_config
    pkg = _package(tmp_path, cfg)
    rs = np.random.RandomState(3)
    feats = [rs.randn(t, cfg.model.cnn_feature_dim).astype(np.float32)
             for t in (10, 7, 10, 4, 9)]
    single = VideoCaptionPredictor(pkg, device="cpu")
    mesh = make_mesh(port(cfg), ["cpu"] * 4)
    sharded = VideoCaptionPredictor(pkg, mesh=mesh)
    assert len(sharded.replicas) == 4
    kwargs = dict(method=method, max_length=6)
    if method == "beam":
        kwargs["beam_size"] = 3
    res_single = single.predict_batch(feats, **kwargs)
    res_sharded = sharded.predict_batch(feats, **kwargs)
    assert len(res_single) == len(res_sharded) == 5
    for a, b in zip(res_single, res_sharded):
        assert a["tokens"] == b["tokens"]
        assert a["caption"] == b["caption"]


def test_predictor_mesh_requires_data_axis(tiny_config, tmp_path):
    pkg = _package(tmp_path, tiny_config)
    bad = Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("model",))
    with pytest.raises(ValueError, match="data"):
        VideoCaptionPredictor(pkg, mesh=bad)


# ------------------------------------------------------------- multihost


def test_dryrun_multihost_two_processes(tmp_path):
    report = dryrun_multihost(num_processes=2, workdir=tmp_path, rows_per_process=4)
    assert report["ok"] and report["global_devices"] == 2
    assert report["loss"] == report["replay_loss"]
    assert sorted(report["rows"]) == [f"clip{i:03d}" for i in range(8)]
    assert (tmp_path / "ckpt" / "checkpoint_epoch_0000.pth").exists()
    assert (tmp_path / "ckpt" / "latest_checkpoint.pth").exists()


def test_multihost_worker_refuses_unprepared_env(tmp_path):
    """The worker entry fails without the launcher's environment rather
    than starting a process group of the wrong size."""
    repo = str(Path(__file__).resolve().parents[1])
    result = subprocess.run(
        [sys.executable, "-m", "video_captioning_tpu_torch.parallel.multihost", "--worker",
         "--process-id", "0", "--num-processes", "1", "--coordinator", "127.0.0.1:1",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": repo})
    assert result.returncode != 0
    assert "launched by dryrun_multihost" in (result.stderr + result.stdout)


def test_spawn_ranks_reports_each_rank_and_a_failure(tmp_path):
    assert spawn_ranks(workers.nothing, 2, timeout=TIMEOUT, workdir=tmp_path / "a") == [0, 1]
    with pytest.raises(Exception):
        spawn_ranks(workers.train_step, 2, ({}, {}, {}, 1, tmp_path), timeout=TIMEOUT,
                    workdir=tmp_path / "b")


def test_trainer_mesh_without_a_process_group_refuses_more_than_one_device(tiny_config,
                                                                           tmp_path):
    cfg = port(tiny_config)
    cfg.experiment.checkpoint_dir = tmp_path
    cfg.parallel.data_axis = 2
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        VideoCaptioningTrainer(VideoCaptioningModel(cfg, VOCAB), cfg, PortVocabulary(cfg), None,
                               None, device="cpu")
