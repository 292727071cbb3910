"""The port's training path against the JAX package on the same weights
(through the bridge) and the same numpy inputs: the differentiable
whole-sequence recurrence, encoder gradients, the teacher-forced loss with
every parameter gradient, dropout, the trainer end to end, checkpoints and
the CLI."""

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
from video_captioning_tpu.models.encoder import apply_encoder as j_apply_encoder
from video_captioning_tpu.ops.lstm_seq_pallas import lstm_seq_train as j_lstm_seq_train
from video_captioning_tpu.training.losses import label_smoothed_cross_entropy as j_loss
from video_captioning_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data.pipeline import create_data_loaders
from video_captioning_tpu_torch.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models import layers
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model
from video_captioning_tpu_torch.models.encoder import apply_encoder
from video_captioning_tpu_torch.models.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.ops import launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    lstm_seq_train,
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd_reference,
)
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.utils.checkpoint import CheckpointManager

VOCAB = 23


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(got, want, rel):
    """Each leaf's max error over that leaf's largest value, floored at
    1e-3 of the largest value anywhere (a gradient that is zero by
    symmetry, as the attention score bias's, holds rounding noise only)."""
    flat_want, flat_got = _leaves(want), _leaves(got)
    assert [p for p, _ in flat_want] == [p for p, _ in flat_got]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_want)
    for (path, w), (_, g) in zip(flat_want, flat_got):
        w, g = np.asarray(w), np.asarray(g)
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------- lstm_seq_train


def _seq_inputs(mask_kind, T=7, ND=2, B=5, H=8, seed=0):
    rs = np.random.RandomState(seed)
    xproj = (rs.randn(T, ND, B, 4 * H) * 0.5).astype(np.float32)
    w_hh = (rs.randn(ND, H, 4 * H) / np.sqrt(H)).astype(np.float32)
    if mask_kind == "ragged":
        lengths = np.array([T, 3, 1, T - 1, 5])[:B]
    elif mask_kind == "none":
        lengths = np.full(B, T)
    else:  # "one_step": every row valid at its first step only
        lengths = np.ones(B, int)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    probes = [rs.randn(*s).astype(np.float32) for s in ((T, ND, B, H), (ND, B, H), (ND, B, H))]
    return xproj, w_hh, mask, probes


# Case -> (mask kind, shape overrides): the mask kinds, then the edges the
# card's tiling must take: B = 1 with a length-1 row, T = 1, H = 40 (not a
# multiple of 16).
_SEQ_CASES = {"ragged": ("ragged", {}), "none": ("none", {}), "one_step": ("one_step", {}),
              "B1": ("one_step", dict(B=1)), "T1": ("ragged", dict(T=1)),
              "H40": ("ragged", dict(H=40))}


@pytest.mark.parametrize("mask_kind", list(_SEQ_CASES))
def test_plain_lstm_seq_train_matches_jax_kernel(mask_kind):
    """Values and gradients of the probe loss sum(outs*P) + sum(h_last*Ph)
    + sum(c_last*Pc): the nonzero Ph and Pc give nonzero dh_last and
    dc_last. Both sides hold the same bf16-operand contract; they differ
    only where XLA:CPU and torch sum in different orders, which can move a
    bf16 rounding of h or dgates by one ulp, so the tolerance is 1e-3 of
    each output's largest value."""
    kind, shape = _SEQ_CASES[mask_kind]
    xproj, w_hh, mask, (P, Ph, Pc) = _seq_inputs(kind, **shape)

    def j_probe(x, w):
        outs, (h, c) = j_lstm_seq_train(x, w, jnp.asarray(mask), 128, True)
        return jnp.sum(outs * P) + jnp.sum(h * Ph) + jnp.sum(c * Pc), (outs, h, c)

    (_, want), (want_dx, want_dw) = jax.value_and_grad(j_probe, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xproj), jnp.asarray(w_hh))
    x_t = torch.tensor(xproj, requires_grad=True)
    w_t = torch.tensor(w_hh, requires_grad=True)
    outs, (h, c) = lstm_seq_train(x_t, w_t, None if kind == "none" else torch.tensor(mask))
    ((outs * torch.tensor(P)).sum() + (h * torch.tensor(Ph)).sum()
     + (c * torch.tensor(Pc)).sum()).backward()
    for got, ref in zip((outs, h, c, x_t.grad, w_t.grad), (*want, want_dx, want_dw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())


def test_plain_lstm_seq_train_residuals_and_cotangents():
    """The forward's residuals are what the backward reads, padded steps
    emit zero and carry the state, and a missing cotangent means zeros."""
    xproj, w_hh, mask, (P, Ph, Pc) = _seq_inputs("ragged", seed=1)
    x, w, m = torch.tensor(xproj), torch.tensor(w_hh).to(torch.bfloat16), torch.tensor(mask)
    outs, h_last, c_last, gact, h_keep, c_keep = lstm_seq_train_fwd_reference(x, w, m)
    pad = (m.T == 0)[:, None, :, None].expand(outs.shape)
    assert torch.all(outs[pad] == 0)
    assert torch.equal(h_keep[-1], h_last) and torch.equal(c_keep[-1], c_last)
    assert gact.shape == x.shape and gact.dtype == x.dtype
    assert h_keep.dtype == c_keep.dtype == torch.float32
    zeros = torch.zeros_like(h_last)
    none = lstm_seq_train_bwd_reference(gact, h_keep, c_keep, w, m, torch.tensor(P))
    explicit = lstm_seq_train_bwd_reference(gact, h_keep, c_keep, w, m, torch.tensor(P),
                                            zeros, zeros)
    for a, b in zip(none, explicit):
        assert torch.equal(a, b)
    # dxproj is zero at padded steps: they take no part in the loss.
    step_pad = (m.T == 0)[:, None, :, None].expand(none[0].shape)
    assert torch.all(none[0][step_pad] == 0)


def test_lstm_seq_train_on_cpu_counts_no_launch():
    reset_launch_counts()
    xproj, w_hh, mask, _ = _seq_inputs("ragged")
    x = torch.tensor(xproj, requires_grad=True)
    outs, (h, c) = lstm_seq_train(x, torch.tensor(w_hh), torch.tensor(mask))
    (outs.sum() + h.sum() + c.sum()).backward()
    assert launch_counts()["lstm_seq_train_fwd"] == 0
    assert launch_counts()["lstm_seq_train_bwd"] == 0


# -------------------------------------------------------- model grads


def _pair(cfg, seed=0):
    params = init_model(jax.random.PRNGKey(seed), cfg, VOCAB)
    pcfg = port(cfg)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return params, model, pcfg


def _ragged_mask(B, T, rs):
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("interpret", [False, True])
def test_encoder_train_grads_match_jax(tiny_config, interpret):
    """train=True with dropout off (JAX rng=None, no generator here).
    interpret=True: the lstm_seq_train contract on both sides (Pallas
    interpreter vs the plain version); False: float32 scans under autodiff.
    Tolerance: 1e-3 of each gradient's largest value for the bf16 contract
    (rounding flips), 2e-5 for float32 (sum order)."""
    cfg = tiny_config
    cfg.kernels.interpret = interpret
    params, model, pcfg = _pair(cfg, seed=1)
    rs = np.random.RandomState(2)
    feats = rs.randn(4, 10, cfg.model.cnn_feature_dim).astype(np.float32)
    mask = _ragged_mask(4, 10, rs)

    def j_loss_fn(p):
        enc, fin = j_apply_encoder(p, cfg, jnp.asarray(feats), jnp.asarray(mask), train=True)
        return jnp.sum(enc ** 2) + jnp.sum(fin ** 2)

    want_loss, want = jax.value_and_grad(j_loss_fn)(params["encoder"])
    enc, fin = apply_encoder(model.encoder, pcfg, torch.from_numpy(feats),
                             torch.from_numpy(mask), train=True)
    loss = (enc ** 2).sum() + (fin ** 2).sum()
    loss.backward()
    grads = {f"encoder.{k}": p.grad for k, p in model.encoder.named_parameters()}
    full = jax_params_from_state_dict({**grads, **{
        k: torch.zeros_like(v) for k, v in model.state_dict().items() if k not in grads}}, pcfg)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(full["encoder"], want, 1e-3 if interpret else 2e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("interpret", [False, True])
def test_apply_model_loss_and_all_grads_match_jax(tiny_config, interpret, remat):
    """Teacher-forced logits, the label-smoothed loss and the gradient of
    every parameter against jax.value_and_grad of the JAX loss, dropout off,
    with remat_attention on and off (values and gradients unchanged)."""
    cfg = tiny_config
    cfg.kernels.interpret = interpret
    cfg.training.remat_attention = remat
    params, model, pcfg = _pair(cfg, seed=3)
    rs = np.random.RandomState(4)
    feats = rs.randn(3, 10, cfg.model.cnn_feature_dim).astype(np.float32)
    inp = rs.randint(0, VOCAB, (3, 8)).astype(np.int32)
    tgt = rs.randint(1, VOCAB, (3, 8)).astype(np.int32)
    tgt[0, 5:] = 0

    def j_loss_fn(p):
        out = j_cap.apply_model(p, cfg, jnp.asarray(feats), jnp.asarray(inp), train=True, rng=None)
        return j_loss(out["logits"], jnp.asarray(tgt), 0, 0.1), out["logits"]

    (want_loss, want_logits), want = jax.value_and_grad(j_loss_fn, has_aux=True)(params)
    out = apply_model(model, pcfg, torch.from_numpy(feats), torch.from_numpy(inp), train=True)
    loss = label_smoothed_cross_entropy(out["logits"], torch.from_numpy(tgt), 0, 0.1)
    loss.backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = jax_params_from_state_dict({k: p.grad for k, p in model.named_parameters()}, pcfg)
    _assert_trees_close(got, want, 1e-3 if interpret else 1e-4)


# ------------------------------------------------------------ dropout


def test_dropout_keep_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = layers.dropout(x, 0.3, g, train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))


def test_dropout_is_identity_in_eval_without_generator_or_rate():
    x = torch.randn(4, 5)
    g = torch.Generator().manual_seed(0)
    assert layers.dropout(x, 0.3, g, train=False) is x
    assert layers.dropout(x, 0.3, None, train=True) is x
    assert layers.dropout(x, 0.0, g, train=True) is x


def test_dropout_is_deterministic_from_seed():
    x = torch.randn(64, 32)
    a = layers.dropout(x, 0.5, torch.Generator().manual_seed(7), train=True)
    b = layers.dropout(x, 0.5, torch.Generator().manual_seed(7), train=True)
    c = layers.dropout(x, 0.5, torch.Generator().manual_seed(8), train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_placement(tiny_config):
    """Encoder: after the output projection (zeros in the encoded frames),
    not on the final state; attention: on the weights (rows no longer sum
    to one, dropped entries are zero); eval runs none."""
    _, model, pcfg = _pair(tiny_config, seed=5)
    rs = np.random.RandomState(5)
    feats = torch.from_numpy(rs.randn(6, 10, 24).astype(np.float32))
    inp = torch.from_numpy(rs.randint(1, VOCAB, (6, 8)))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        enc, fin = apply_encoder(model.encoder, pcfg, feats, train=True, generator=g)
        enc_eval, fin_eval = apply_encoder(model.encoder, pcfg, feats)
        dropped = (enc == 0).float().mean().item()
        assert 0.2 < dropped < 0.4  # encoder_dropout 0.3
        assert (enc_eval != 0).all() and (fin != 0).all()
        out = apply_model(model, pcfg, feats, inp, train=True, generator=g)
        w = out["attention_weights"]
        assert (w == 0).any()
        assert not torch.allclose(w.sum(-1), torch.ones(w.shape[:2]))
        w_eval = apply_model(model, pcfg, feats, inp)["attention_weights"]
        torch.testing.assert_close(w_eval.sum(-1), torch.ones(w.shape[:2]))


# ------------------------------------------------- trainer end to end


CAPTIONS = ["a man is running", "a dog is barking", "a cat is sleeping", "a bird is flying"]


def _tiny_port_config(tiny_config, ckpt_dir):
    cfg = port(tiny_config)
    cfg.data.vocab_threshold = 1
    cfg.training.batch_size = 4
    cfg.training.num_epochs = 3
    cfg.training.learning_rate = 5e-3
    cfg.training.save_every_n_epochs = 1
    cfg.training.num_workers = 1
    cfg.experiment.checkpoint_dir = Path(ckpt_dir)
    cfg.experiment.log_every_n_steps = 1
    cfg.validate()
    return cfg


def _rows(tmp_path, cfg, n=16):
    rs = np.random.RandomState(0)
    patterns = rs.randn(4, cfg.model.cnn_feature_dim).astype(np.float32)
    rows = []
    for i in range(n):
        feats = patterns[i % 4][None].repeat(cfg.data.frames_per_video, 0)
        feats = feats + 0.01 * rs.randn(*feats.shape).astype(np.float32)
        path = tmp_path / f"v{i}.npy"
        np.save(path, feats)
        rows.append({"video_id": f"v{i}", "video_path": "", "feature_path": str(path),
                     "caption": CAPTIONS[i % 4]})
    return rows


def _trainer(tiny_config, tmp_path, **training):
    cfg = _tiny_port_config(tiny_config, tmp_path / "ckpt")
    for k, v in training.items():
        setattr(cfg.training, k, v)
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    rows = _rows(tmp_path, cfg)
    train_loader, val_loader, _ = create_data_loaders(cfg, vocab, rows[:12], rows[12:])
    params = init_model(jax.random.PRNGKey(0), tiny_config, len(vocab))
    model = VideoCaptioningModel(cfg, len(vocab))
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return VideoCaptioningTrainer(model, cfg, vocab, train_loader, val_loader, device="cpu")


def test_trainer_writes_files_keeps_best_by_bleu4_and_resumes(tiny_config, tmp_path):
    trainer = _trainer(tiny_config, tmp_path)
    results = trainer.train()
    ckpt = tmp_path / "ckpt"
    for name in ("best_model.pth", "latest_checkpoint.pth", "training_results.json",
                 "checkpoint_epoch_0000.pth", "checkpoint_epoch_0002.pth"):
        assert (ckpt / name).exists(), name
    assert list((ckpt / "tensorboard").glob("events.out.tfevents.*"))
    assert results == json.loads((ckpt / "training_results.json").read_text())
    bleu = [h["bleu_4"] for h in results["val_history"]]
    assert results["best_val_score"] == max(bleu)
    best = CheckpointManager(ckpt).load_best_model()
    assert best["epoch"] == int(np.argmax(bleu)) and best["metrics"]["bleu_4"] == max(bleu)
    assert results["train_history"][-1]["loss"] < results["train_history"][0]["loss"]

    resumed = _trainer(tiny_config, tmp_path)
    resumed.load_checkpoint(ckpt / "latest_checkpoint.pth")
    assert (resumed.current_epoch, resumed.global_step) == (2, trainer.global_step)
    assert resumed.best_val_score == trainer.best_val_score
    for (k, a), b in zip(trainer.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_trainer_stops_early(tiny_config, tmp_path):
    """A zero learning rate never improves the score: with patience 1 the
    run stops after the second validation."""
    trainer = _trainer(tiny_config, tmp_path, learning_rate=0.0, early_stopping_patience=1,
                       num_epochs=6)
    results = trainer.train()
    assert results["total_epochs"] == 2 and len(results["val_history"]) == 2


def test_trainer_ema_follows_the_warmed_up_decay(tiny_config, tmp_path):
    trainer = _trainer(tiny_config, tmp_path, ema_decay=0.9)
    trainer.generator = None  # dropout off: the step is deterministic
    batch = next(iter(trainer.train_loader))
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for step in (1, 2):
        trainer.train_step(batch)
        d = min(0.9, (1 + step) / (10 + step))
        want = {k: w * d + v * (1 - d) for (k, v), w in
                zip(trainer.model.state_dict().items(), want.values())}
    for k, w in want.items():
        torch.testing.assert_close(trainer.ema[k], w, rtol=1e-6, atol=1e-7)
    assert trainer.eval_state_dict() is trainer.ema


def test_trainer_freeze_encoder_updates_the_decoder_only(tiny_config, tmp_path):
    trainer = _trainer(tiny_config, tmp_path, freeze_encoder=True)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train_step(next(iter(trainer.train_loader)))
    after = trainer.model.state_dict()
    assert trainer.trainable_names and not any(
        n.startswith("encoder.") for n in trainer.trainable_names)
    for k, v in before.items():
        assert torch.equal(after[k], v) == k.startswith("encoder."), k


@pytest.mark.parametrize("option", ["orbax", "profile_dir", "wandb", "bfloat16", "mesh"])
def test_trainer_refuses_unported_options(tiny_config, tmp_path, option):
    cfg = _tiny_port_config(tiny_config, tmp_path)
    if option == "orbax":
        cfg.experiment.checkpoint_backend = "orbax"
    elif option == "profile_dir":
        cfg.experiment.profile_dir = tmp_path
    elif option == "wandb":
        cfg.experiment.use_wandb = True
    elif option == "bfloat16":
        cfg.training.compute_dtype = "bfloat16"
    else:
        cfg.parallel.data_axis = 2
    with pytest.raises(NotImplementedError, match="not ported"):
        VideoCaptioningTrainer(VideoCaptioningModel(cfg, VOCAB), cfg, Vocabulary(cfg),
                               None, None, device="cpu")


def test_bridge_inverse_round_trip_is_exact(tiny_config):
    params = jax.tree_util.tree_map(np.asarray, init_model(jax.random.PRNGKey(9), tiny_config,
                                                            VOCAB))
    cfg = port(tiny_config)
    back = jax_params_from_state_dict(state_dict_from_jax_params(params, cfg), cfg)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(params)]
    for (path, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_resume_refuses_a_jax_written_training_checkpoint(tiny_config, tmp_path):
    import optax

    params = init_model(jax.random.PRNGKey(0), tiny_config, VOCAB)
    JaxCheckpointManager(tmp_path).save_checkpoint(
        params, optax.adam(1e-3).init(params), 0, {}, config=tiny_config)
    with pytest.raises(ValueError, match="written by the JAX package"):
        CheckpointManager(tmp_path).load_checkpoint(tmp_path / "checkpoint_epoch_0000.pth")


def _write_csv(tmp_path, cfg, n=20):
    rows = _rows(tmp_path, cfg, n)
    lines = ["video_id,video_path,feature_path,caption"]
    lines += [f"{r['video_id']},,{r['feature_path']},{r['caption']}" for r in rows]
    (tmp_path / "captions.csv").write_text("\n".join(lines) + "\n")
    return tmp_path / "captions.csv"


def test_cli_train_package_loads_in_the_jax_predictor(tiny_config, tmp_path, monkeypatch):
    """cli.train on the CPU writes a package that the JAX predictor loads
    and decodes to the port predictor's greedy tokens."""
    from video_captioning_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)  # training.log and ensure_dirs() stay here
    cfg = _tiny_port_config(tiny_config, tmp_path / "ckpt")
    (tmp_path / "config.json").write_text(json.dumps(cfg.to_dict()))
    csv_path = _write_csv(tmp_path, cfg)
    trainer = train.main(["--config", "config.json", "--data-file", str(csv_path),
                          "--checkpoint-dir", "ckpt", "--epochs", "2", "--device", "cpu",
                          "--log-level", "WARNING"])
    assert trainer.global_step == 2 * (16 // 4)  # 20 rows: 16 train, batches of 4
    pkg = tmp_path / "ckpt" / "model_for_inference.pth"
    feats = [np.load(tmp_path / f"v{i}.npy") for i in range(4)]
    want = JaxPredictor(pkg).predict_batch(feats, method="greedy")
    got = VideoCaptionPredictor(pkg, device="cpu").predict_batch(feats, method="greedy")
    assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want]
    assert [r["caption"] for r in got] == [r["caption"] for r in want]


def test_cli_train_defaults_to_the_card():
    from video_captioning_tpu_torch.cli import train

    assert train.build_parser().parse_args(["--data-file", "x.csv"]).device == "cuda"
