"""The port's optimizers, clipping, LR schedules, loss and gradient
accumulation against the JAX package's optax chains on the same
gradients."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from video_captioning_tpu.training import optim as j_optim
from video_captioning_tpu.training.losses import label_smoothed_cross_entropy as j_loss
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.training import optim
from video_captioning_tpu_torch.training.losses import label_smoothed_cross_entropy

# float32 on both sides; optax and torch.optim order the same update's
# operations differently, so three steps agree to a few float32 ulps.
RTOL, ATOL = 1e-5, 1e-7


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _params_and_grads(seed=0, steps=3):
    """A two-subtree pytree (encoder, decoder) and three gradient trees:
    the first and third are scaled past the clip norm, the second not."""
    rs = np.random.RandomState(seed)
    shapes = {"encoder": {"w": (4, 3), "b": (3,)}, "decoder": {"w": (5, 2), "b": (2,)}}
    params = {k: {n: rs.randn(*s).astype(np.float32) for n, s in v.items()}
              for k, v in shapes.items()}
    grads = []
    for step, scale in zip(range(steps), (10.0, 0.05, 4.0)):
        grads.append({k: {n: (rs.randn(*s) * scale).astype(np.float32) for n, s in v.items()}
                      for k, v in shapes.items()})
    return params, grads


def _names(tree):
    return [(k, n) for k in tree for n in tree[k]]


def _optax_run(cfg, params, grads, frozen=()):
    tx = j_optim.build_optimizer(cfg, frozen_prefixes=frozen)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)
    return p


def _torch_run(cfg, params, grads, frozen=()):
    pcfg = port(cfg)
    tensors = {(k, n): torch.nn.Parameter(torch.tensor(params[k][n])) for k, n in _names(params)}
    trainable = [t for (k, _), t in tensors.items() if k not in frozen]
    opt = optim.build_optimizer(trainable, pcfg)
    for g in grads:
        opt.zero_grad(set_to_none=True)
        for (k, n), t in tensors.items():
            if k not in frozen:
                t.grad = torch.tensor(g[k][n])
        optim.clip_grad_global_norm_(trainable, pcfg.training.gradient_clip_norm)
        opt.step()
    return tensors


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_three_steps_match_optax(default_config, name):
    cfg = default_config
    cfg.training.optimizer = name
    cfg.training.learning_rate = 1e-2
    cfg.training.weight_decay = 1e-2
    params, grads = _params_and_grads()
    want = _optax_run(cfg, params, grads)
    got = _torch_run(cfg, params, grads)
    for k, n in _names(params):
        np.testing.assert_allclose(got[k, n].detach().numpy(), np.asarray(want[k][n]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{name} {k}.{n}")


def test_freeze_encoder_updates_the_decoder_only_and_clips_its_norm(default_config):
    """optax multi_transform: the frozen encoder gets no update, and the
    clip norm is the decoder's alone (the large encoder gradients must not
    shrink the decoder's step)."""
    cfg = default_config
    cfg.training.learning_rate = 1e-2
    params, grads = _params_and_grads(seed=1)
    for g in grads:
        for n in g["encoder"]:
            g["encoder"][n] = g["encoder"][n] * 100.0
    want = _optax_run(cfg, params, grads, frozen=("encoder",))
    got = _torch_run(cfg, params, grads, frozen=("encoder",))
    for k, n in _names(params):
        np.testing.assert_allclose(got[k, n].detach().numpy(), np.asarray(want[k][n]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{k}.{n}")
        if k == "encoder":
            np.testing.assert_array_equal(got[k, n].detach().numpy(), params[k][n])


@pytest.mark.parametrize("scale", [0.1, 1.0, 3.0])
def test_clip_matches_optax_clip_by_global_norm(scale):
    """Below, at and above the threshold; optax adds no epsilon to the norm
    and keeps gradients whose norm is below the threshold as they are."""
    rs = np.random.RandomState(2)
    grads = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [g * np.float32(scale * 5.0 / norm) for g in grads]
    want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.tensor(g)
    got_norm = optim.clip_grad_global_norm_(params, 5.0)
    np.testing.assert_allclose(got_norm.item(), scale * 5.0, rtol=1e-5)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sched", ["cosine", "step", "plateau", "none"])
def test_lr_at_epoch_matches_jax(default_config, sched):
    cfg = default_config
    cfg.training.scheduler = sched
    cfg.training.num_epochs = 10
    for epoch in range(12):
        assert optim.lr_at_epoch(port(cfg), epoch) == j_optim.lr_at_epoch(cfg, epoch)


def test_plateau_scheduler_matches_jax():
    rs = np.random.RandomState(3)
    metrics = list(rs.rand(6)) + [0.0] * 14 + [2.0] + [0.5] * 8
    mine, theirs = optim.PlateauScheduler(lr=1e-3), j_optim.PlateauScheduler(lr=1e-3)
    lrs = []
    for m in metrics:
        lrs.append(mine.step(m))
        assert lrs[-1] == theirs.step(m)
    assert min(lrs) < 1e-3  # the plateau halved it
    again = optim.PlateauScheduler(lr=0.0)
    again.load_state_dict(mine.state_dict())
    assert again == mine


def test_learning_rate_is_written_into_every_param_group(default_config):
    groups = [{"params": [torch.nn.Parameter(torch.zeros(2))]},
              {"params": [torch.nn.Parameter(torch.zeros(3))]}]
    opt = torch.optim.Adam(groups, lr=1.0)
    optim.set_learning_rate(opt, 0.25)
    assert [g["lr"] for g in opt.param_groups] == [0.25, 0.25]
    assert optim.get_learning_rate(opt) == 0.25


def test_unknown_optimizer_raises(default_config):
    cfg = port(default_config)
    cfg.training.optimizer = "lamb"
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        optim.build_optimizer([torch.nn.Parameter(torch.zeros(1))], cfg)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_label_smoothed_cross_entropy_matches_jax(smoothing, weighted):
    rs = np.random.RandomState(4)
    logits = (rs.randn(3, 6, 11) * 3).astype(np.float32)
    targets = rs.randint(0, 11, (3, 6)).astype(np.int32)
    targets[1, 3:] = 0
    weights = rs.rand(3, 6).astype(np.float32) if weighted else None
    want = j_loss(jnp.asarray(logits), jnp.asarray(targets), 0, smoothing,
                  None if weights is None else jnp.asarray(weights))
    got = label_smoothed_cross_entropy(torch.tensor(logits), torch.tensor(targets), 0,
                                       smoothing, None if weights is None else torch.tensor(weights))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_loss_matches_torch_cross_entropy():
    """The upstream trainer's CrossEntropyLoss(ignore_index=0,
    label_smoothing=0.1)."""
    rs = np.random.RandomState(5)
    logits = torch.tensor(rs.randn(4, 7, 13).astype(np.float32))
    targets = torch.tensor(rs.randint(0, 13, (4, 7)))
    want = torch.nn.CrossEntropyLoss(ignore_index=0, label_smoothing=0.1)(
        logits.reshape(-1, 13), targets.reshape(-1))
    got = label_smoothed_cross_entropy(logits, targets, 0, 0.1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_grad_accumulation_equals_the_full_batch(tiny_config, tmp_path):
    """Two micro-batches of 2, gradients averaged, one SGD update: the same
    loss and parameters as one step on the batch of 4 (dropout off; every
    micro-batch holds as many target tokens, so the mean of the micro-batch
    means is the batch's mean)."""
    from video_captioning_tpu.models import init_model
    from video_captioning_tpu_torch.data.vocabulary import Vocabulary
    from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
    from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params
    from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer

    params = init_model(jax.random.PRNGKey(0), tiny_config, 23)
    rs = np.random.RandomState(6)
    batch = {"video_features": rs.randn(4, 10, 24).astype(np.float32),
             "input_tokens": rs.randint(0, 23, (4, 8)).astype(np.int32),
             "target_tokens": rs.randint(1, 23, (4, 8)).astype(np.int32)}

    def step(accum):
        cfg = port(tiny_config)
        cfg.training.grad_accum_steps = accum
        cfg.training.learning_rate = 1e-1
        cfg.training.optimizer = "sgd"
        cfg.experiment.checkpoint_dir = tmp_path / f"a{accum}"
        cfg.experiment.use_tensorboard = False
        model = VideoCaptioningModel(cfg, 23)
        model.load_state_dict(state_dict_from_jax_params(params, cfg))
        trainer = VideoCaptioningTrainer(model, cfg, Vocabulary(cfg), None, None, device="cpu")
        trainer.generator = None  # dropout off
        loss = trainer.train_step(batch)
        return loss, model.state_dict()

    loss1, full = step(1)
    loss2, accumulated = step(2)
    torch.testing.assert_close(loss2, loss1, rtol=1e-6, atol=0)
    for k, v in full.items():
        torch.testing.assert_close(accumulated[k], v, rtol=1e-5, atol=1e-6, msg=k)
