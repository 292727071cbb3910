"""Training loop on one device.

Counterpart of video_captioning_tpu/training/trainer.py
(``VideoCaptioningTrainer``) with the same schedule of work and the same
files: label-smoothed CE with PAD ignored, global-norm clipping, the
configured optimizer and per-epoch LR schedule, validation each
``val_every_n_epochs`` (eval loss and greedy decode scored by
``CaptionMetrics``), best-by-BLEU-4 checkpoints (−loss where BLEU is
missing), early stopping, periodic saves, gradient accumulation, parameter
EMA, ``training_results.json`` and resume.

* A step is forward, backward, clip and optimizer update on the model's
  device; the loss stays a device scalar and is read one step late, so the
  host never waits for the step it just issued (the NaN guard reads it
  there too).
* Both model families train (``model.architecture``): the LSTM
  captioner and the transformer (dropout at ``transformer_dropout``; the
  transformer's teacher forcing needs no kernel). On a CUDA device the LSTM
  encoder's recurrence runs in the ``lstm_seq_train`` kernels in training
  and in ``lstm_seq`` during validation's greedy decode, as the
  configuration's kernel gates and the kernels' domain
  (``ops.lstm_seq.lstm_seq_eligible``) say.
* Dropout draws from one ``torch.Generator`` on the model's device, seeded
  with ``training.seed``.
* Checkpoints hold the parameters in the JAX package's layout, so its
  predictor loads them; the optimizer state is the port's own.

Not ported: the orbax checkpoint backend, ``experiment.profile_dir``,
Weights & Biases, device meshes and ``compute_dtype="bfloat16"``; each
raises ``NotImplementedError`` when the trainer is built.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.vocabulary import Vocabulary
from ..generation import greedy_generate
from ..models.captioner import VideoCaptioningModel, apply_model, count_params, encode
from ..models.weights import jax_params_from_state_dict, state_dict_from_jax_params
from ..utils.checkpoint import OPTIMIZER_FORMAT, CheckpointManager
from ..utils.metrics import CaptionMetrics
from ..utils.tb_writer import create_summary_writer
from . import optim
from .losses import label_smoothed_cross_entropy

Tensor = torch.Tensor


def check_trainable(config: Config) -> None:
    """Raise NotImplementedError for the training options not ported yet."""
    t, e, p = config.training, config.experiment, config.parallel
    unsupported = [
        (e.checkpoint_backend == "orbax", "experiment.checkpoint_backend='orbax'"),
        (e.profile_dir is not None, "experiment.profile_dir"),
        (e.use_wandb, "experiment.use_wandb"),
        (t.compute_dtype == "bfloat16", "training.compute_dtype='bfloat16'"),
        (p.data_axis > 1 or p.model_axis > 1, "a device mesh (parallel.data_axis/model_axis)"),
    ]
    names = [name for bad, name in unsupported if bad]
    if names:
        raise NotImplementedError(
            f"not ported to video_captioning_tpu_torch yet: {', '.join(names)}")


def _to_numpy(tree):
    if isinstance(tree, Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


class VideoCaptioningTrainer:
    """Trains ``model`` in place on ``device``."""

    def __init__(
        self,
        model: VideoCaptioningModel,
        config: Config,
        vocabulary: Vocabulary,
        train_loader,
        val_loader,
        device: Union[str, torch.device] = "cuda",
    ):
        check_trainable(config)
        self.config = config
        self.vocabulary = vocabulary
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logging.getLogger(__name__)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # float32 products stay float32: only the recurrent products of
            # the lstm_seq kernels take bf16 operands, as on the TPU.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)

        # freeze_encoder: the encoder gets no update and the clip norm is
        # taken over the decoder's gradients only (optax multi_transform).
        frozen = config.training.freeze_encoder
        for p in self.model.encoder.parameters():
            p.requires_grad_(not frozen)
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.trainable_names = [n for n, _ in named]
        self.trainable = [p for _, p in named]
        self.optimizer = optim.build_optimizer(self.trainable, config)

        # Parameter EMA: a float32 shadow of the state dict that validation,
        # best-model selection and export read.
        self.ema: Optional[Dict[str, Tensor]] = None
        if config.training.ema_decay > 0.0:
            self.ema = {k: v.detach().float().clone() for k, v in self.model.state_dict().items()}
        self._eval_model: Optional[VideoCaptioningModel] = None

        self.metrics = CaptionMetrics(vocabulary)
        self.checkpoint_manager = CheckpointManager(config.experiment.checkpoint_dir)
        self.tensorboard_writer = None
        if config.experiment.use_tensorboard:
            self.tensorboard_writer = create_summary_writer(
                Path(config.experiment.checkpoint_dir) / "tensorboard")

        self.plateau = None
        if config.training.scheduler.lower() == "plateau":
            self.plateau = optim.PlateauScheduler(lr=config.training.learning_rate)

        self.current_epoch = 0
        self.global_step = 0
        self.best_val_score = -float("inf")
        self.patience_counter = 0
        self.train_history: List[Dict[str, Any]] = []
        self.val_history: List[Dict[str, Any]] = []
        self.generator = torch.Generator(device=self.device).manual_seed(config.training.seed)

    # ------------------------------------------------------------ steps

    def _place(self, batch: dict) -> Dict[str, Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def _loss(self, model, feats: Tensor, inp: Tensor, tgt: Tensor, train: bool) -> Tensor:
        out = apply_model(model, self.config, feats, inp, train=train,
                          generator=self.generator if train else None)
        return label_smoothed_cross_entropy(out["logits"], tgt, self.vocabulary.pad_idx,
                                            self.config.training.label_smoothing)

    def train_step(self, batch: dict) -> Tensor:
        """One optimizer update on a numpy batch; returns the loss as a
        device scalar (the mean over micro-batches with accumulation)."""
        b = self._place(batch)
        parts = (b["video_features"], b["input_tokens"], b["target_tokens"])
        accum = self.config.training.grad_accum_steps
        if parts[0].shape[0] % accum:
            raise ValueError(f"batch of {parts[0].shape[0]} does not split into "
                             f"grad_accum_steps={accum} micro-batches")
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=self.device)
        for micro in zip(*(x.chunk(accum) for x in parts)):
            micro_loss = self._loss(self.model, *micro, train=True)
            (micro_loss / accum).backward()
            loss += micro_loss.detach()
        loss /= accum
        clip = self.config.training.gradient_clip_norm
        if clip and clip > 0:
            optim.clip_grad_global_norm_(self.trainable, clip)
        self.optimizer.step()
        self.global_step += 1
        if self.ema is not None:
            self._update_ema()
        return loss

    @torch.no_grad()
    def _update_ema(self) -> None:
        # Decay warm-up as in the JAX package: d_t = min(d, (1+t)/(10+t)).
        t = float(self.global_step)
        d = min(self.config.training.ema_decay, (1.0 + t) / (10.0 + t))
        for k, v in self.model.state_dict().items():
            self.ema[k].mul_(d).add_(v.float(), alpha=1.0 - d)

    # ------------------------------------------------------------ epoch

    def train_epoch(self) -> Dict[str, float]:
        self.model.train()
        total_loss = 0.0
        num_batches = len(self.train_loader)
        self.train_loader.set_epoch(self.current_epoch)
        pending_loss = None
        bad_steps = 0
        max_bad = self.config.training.max_bad_steps
        for batch_idx, batch in enumerate(self.train_loader):
            loss = self.train_step(batch)
            # Read the previous step's loss: the device queue never drains.
            if pending_loss is not None:
                loss_val = float(pending_loss)
                total_loss += loss_val
                if not np.isfinite(loss_val):
                    bad_steps += 1
                    if max_bad and bad_steps >= max_bad:
                        raise RuntimeError(f"Non-finite loss for {bad_steps} consecutive "
                                           f"steps at global step {self.global_step}")
                else:
                    bad_steps = 0
            pending_loss = loss

            if batch_idx % self.config.experiment.log_every_n_steps == 0:
                loss_val = float(loss)
                lr = optim.get_learning_rate(self.optimizer)
                self.logger.info(f"Epoch {self.current_epoch}, Batch {batch_idx}/{num_batches}, "
                                 f"Loss: {loss_val:.4f}, LR: {lr:.6f}")
                if self.tensorboard_writer:
                    self.tensorboard_writer.add_scalar("Train/BatchLoss", loss_val,
                                                       self.global_step)
                    self.tensorboard_writer.add_scalar("Train/LearningRate", lr,
                                                       self.global_step)
        if pending_loss is not None:
            total_loss += float(pending_loss)
        return {"loss": total_loss / max(num_batches, 1)}

    def eval_state_dict(self) -> Dict[str, Tensor]:
        """The weights validation and export use: the EMA shadow when
        ``training.ema_decay`` is on, the model's own otherwise."""
        return self.ema if self.ema is not None else self.model.state_dict()

    def _eval_target(self) -> VideoCaptioningModel:
        if self.ema is None:
            return self.model
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model)
        self._eval_model.load_state_dict(self.ema)
        return self._eval_model

    @torch.no_grad()
    def validate_epoch(self) -> Dict[str, float]:
        model = self._eval_target().eval()
        cfg, vocab = self.config, self.vocabulary
        total_loss, count = 0.0, 0
        predictions: List[str] = []
        references: List[str] = []
        for batch in self.val_loader:
            b = self._place(batch)
            feats = b["video_features"]
            loss = self._loss(model, feats, b["input_tokens"], b["target_tokens"], train=False)
            enc, final, mask = encode(model, cfg, feats)
            tokens = greedy_generate(model, cfg, enc, final, vocab.start_idx, vocab.end_idx,
                                     cfg.model.max_sequence_length, mask)["generated_tokens"]
            total_loss += float(loss)
            count += 1
            predictions.extend(vocab.decode_caption(seq) for seq in tokens.cpu().tolist())
            references.extend(vocab.decode_caption(seq) for seq in batch["target_tokens"].tolist())
        scores = self.metrics.compute_metrics(predictions, references)
        return {"loss": total_loss / max(count, 1), **scores}

    # ------------------------------------------------------------- main

    def train(self) -> Dict[str, Any]:
        self.logger.info("Starting training...")
        self.logger.info(f"Model has {count_params(self.model):,} trainable parameters")
        start_time = time.time()
        val_metrics: Dict[str, float] = {}
        last_val_epoch = -1
        for epoch in range(self.current_epoch, self.config.training.num_epochs):
            self.current_epoch = epoch
            train_metrics = self.train_epoch()
            self.train_history.append({"epoch": epoch, **train_metrics})

            stop = False
            if epoch % self.config.training.val_every_n_epochs == 0:
                val_metrics = self.validate_epoch()
                last_val_epoch = epoch
                self.val_history.append({"epoch": epoch, **val_metrics})
                self.logger.info(f"Epoch {epoch}: Train Loss: {train_metrics['loss']:.4f}, "
                                 f"Val Loss: {val_metrics['loss']:.4f}, "
                                 f"Val BLEU-4: {val_metrics.get('bleu_4', 0):.4f}")
                self._log_epoch(epoch, train_metrics, val_metrics)
                current_score = val_metrics.get("bleu_4", -val_metrics["loss"])
                if current_score > self.best_val_score:
                    self.best_val_score = current_score
                    self.patience_counter = 0
                    self._save(epoch, val_metrics, is_best=True)
                else:
                    self.patience_counter += 1
                if self.patience_counter >= self.config.training.early_stopping_patience:
                    self.logger.info(f"Early stopping at epoch {epoch}")
                    stop = True
            if stop:
                break

            self._scheduler_step(epoch, val_metrics)
            if epoch % self.config.training.save_every_n_epochs == 0:
                save_metrics = {"train_loss": train_metrics["loss"]}
                if last_val_epoch >= 0:
                    save_metrics.update(val_metrics)
                    save_metrics["val_epoch"] = last_val_epoch
                self._save(epoch, save_metrics, is_best=False)

        total_time = time.time() - start_time
        self.logger.info(f"Training completed in {total_time:.2f} seconds")
        results = {
            "best_val_score": self.best_val_score,
            "total_epochs": self.current_epoch + 1,
            "total_time": total_time,
            "train_history": self.train_history,
            "val_history": self.val_history,
        }
        with open(Path(self.config.experiment.checkpoint_dir) / "training_results.json", "w") as f:
            json.dump(results, f, indent=2)
        if self.tensorboard_writer:
            self.tensorboard_writer.close()
        return results

    # ---------------------------------------------------------- helpers

    def _scheduler_step(self, epoch: int, val_metrics: Dict[str, float]) -> None:
        sched = self.config.training.scheduler.lower()
        if sched in ("cosine", "step"):
            optim.set_learning_rate(self.optimizer, optim.lr_at_epoch(self.config, epoch + 1))
        elif sched == "plateau" and self.plateau is not None:
            metric = val_metrics.get("bleu_4", -val_metrics.get("loss", 0.0))
            optim.set_learning_rate(self.optimizer, self.plateau.step(metric))

    def _log_epoch(self, epoch, train_metrics, val_metrics) -> None:
        if not self.tensorboard_writer:
            return
        self.tensorboard_writer.add_scalar("Train/EpochLoss", train_metrics["loss"], epoch)
        self.tensorboard_writer.add_scalar("Val/EpochLoss", val_metrics["loss"], epoch)
        for name, value in val_metrics.items():
            if name != "loss":
                self.tensorboard_writer.add_scalar(f"Val/{name}", value, epoch)

    def _optimizer_state(self) -> Dict[str, Any]:
        return {
            "format": OPTIMIZER_FORMAT,
            "optimizer": type(self.optimizer).__name__,
            "param_names": list(self.trainable_names),
            "state": _to_numpy(self.optimizer.state_dict()),
        }

    def _save(self, epoch: int, metrics: Dict[str, float], is_best: bool) -> None:
        additional = {"global_step": self.global_step, "best_val_score": self.best_val_score}
        best_state = None
        if self.ema is not None:
            best_state = additional["ema_state_dict"] = jax_params_from_state_dict(
                self.ema, self.config)
        self.checkpoint_manager.save_checkpoint(
            jax_params_from_state_dict(self.model.state_dict(), self.config),
            self._optimizer_state(),
            epoch,
            metrics,
            scheduler_state=self.plateau.state_dict() if self.plateau else None,
            config=self.config,
            is_best=is_best,
            additional_info=additional,
            # best_model.pth holds the EMA weights that earned the score; the
            # raw parameters stay under raw_model_state_dict for resume.
            best_model_state=best_state,
        )

    def _state_dict_on_device(self, params) -> Dict[str, Tensor]:
        return {k: v.to(self.device) for k, v in
                state_dict_from_jax_params(params, self.config).items()}

    def load_checkpoint(self, checkpoint_path: Path) -> Dict[str, Any]:
        """Resume from a training checkpoint that this package wrote."""
        checkpoint = self.checkpoint_manager.load_checkpoint(checkpoint_path)
        opt = checkpoint["optimizer_state_dict"]
        if not isinstance(opt, dict) or opt.get("format") != OPTIMIZER_FORMAT:
            raise ValueError(f"{checkpoint_path}: the optimizer state is not in "
                             f"{OPTIMIZER_FORMAT!r} format; resume takes checkpoints "
                             "written by video_captioning_tpu_torch")
        if (opt["optimizer"] != type(self.optimizer).__name__
                or opt["param_names"] != self.trainable_names):
            raise ValueError(f"{checkpoint_path}: saved with a different optimizer "
                             f"({opt['optimizer']}, {len(opt['param_names'])} trainable "
                             "tensors); resume with the training config used at save time")
        raw = checkpoint.get("raw_model_state_dict", checkpoint["model_state_dict"])
        self.model.load_state_dict(self._state_dict_on_device(raw))
        self.optimizer.load_state_dict(_to_torch(opt["state"]))
        if self.plateau is not None and "scheduler_state_dict" in checkpoint:
            self.plateau.load_state_dict(checkpoint["scheduler_state_dict"])
        if self.ema is not None:
            src = checkpoint.get("ema_state_dict", raw)  # no EMA saved: restart it
            self.ema = {k: v.float() for k, v in self._state_dict_on_device(src).items()}
        self.current_epoch = checkpoint["epoch"]
        self.global_step = checkpoint.get("global_step", 0)
        self.best_val_score = checkpoint.get("best_val_score", -float("inf"))
        self.logger.info(f"Loaded checkpoint from epoch {self.current_epoch}")
        return checkpoint
