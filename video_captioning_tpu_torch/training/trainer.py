"""Training loop, on one device or data-parallel over a mesh.

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
* ``training.compute_dtype="bfloat16"`` is the JAX trainer's cast policy:
  the float32 master parameters are cast to bfloat16 inside the loss by a
  differentiable ``.to()`` (gradients, clipping and the optimizer stay
  float32), the features are cast on the host before the copy, the loss
  reduces in float32, and validation runs its loss and greedy decode on a
  bfloat16 copy of the weights (under a fused decode-step flag through its
  kernels, whose wrappers cast their operands as the JAX ones do).
* ``experiment.profile_dir``: a ``torch.profiler`` trace of epoch 0's
  first five steps (the JAX trainer's ``jax.profiler`` window), written
  there as ``trace_epoch0.pt.trace.json``.
* ``experiment.use_wandb``: ``wandb.init`` with the JAX trainer's project,
  name and config, ``log`` at its points and keys, ``finish`` at the end;
  where ``wandb`` does not import, a warning and training goes on.
* Checkpoints hold the parameters in the JAX package's layout, so its
  predictor loads them. The optimizer state is the port's own; resume
  also reads a checkpoint the JAX trainer wrote, converting its optax
  state (``utils.checkpoint``, ``optim.torch_state_from_optax``).

* On a mesh (``parallel/mesh.py``; one process a device under
  ``torch.distributed``) the step is data-parallel over ``data``, as the
  JAX step is over its ``P('data')`` batch: each rank takes the loss of
  its own rows as its share of the global batch's token mean (its token
  sum over the global token count), the gradients are summed over the
  ``data`` group, then clipped by the norm of the whole gradient, and the
  loss summed over ``data`` is the global one on every rank. With
  ``model_axis > 1`` the vocabulary matrices are split over ``model``
  (``parallel/sharding.py``). Rank 0 alone writes checkpoints, packages,
  TensorBoard, W&B and ``training_results.json``; every rank validates.
* ``experiment.checkpoint_backend="orbax"``: asynchronous
  ``torch.distributed.checkpoint`` saves of the last five epochs
  (``utils/orbax_ckpt.py``), ``load_orbax_checkpoint`` to resume, and a
  host snapshot of the best epoch's evaluation weights
  (``best_eval_state``), which no later save overwrites.
* ``experiment.compilation_cache_dir`` is accepted and logged: the port
  has no compilation cache (``utils/compile_cache.py``).
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import place_batch
from ..parallel import sharding
from ..parallel.mesh import Mesh, distributed, make_mesh
from ..data.vocabulary import Vocabulary
from ..generation import greedy_generate
from ..models.captioner import VideoCaptioningModel, apply_model, count_params, encode
from ..models.weights import jax_params_from_state_dict, state_dict_from_jax_params
from ..utils.checkpoint import OPTIMIZER_FORMAT, CheckpointManager, OptaxState
from ..utils.compile_cache import maybe_enable_from_config
from ..utils.metrics import CaptionMetrics
from ..utils.tb_writer import create_summary_writer
from . import optim
from .losses import label_smoothed_cross_entropy, label_smoothed_cross_entropy_terms

Tensor = torch.Tensor


def _to_numpy(tree):
    if isinstance(tree, Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch_tensors(tree, device):
    if isinstance(tree, Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_torch_tensors(v, device) for k, v in tree.items()}
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
    """Trains ``model`` in place on ``device``: this process's device of
    ``mesh`` (default: ``make_mesh`` over the ``torch.distributed`` ranks
    when a process group is up, else a mesh of ``device`` alone). The
    train loader yields this rank's rows (``DataLoader(shard_index=data
    index, num_shards=data size)``)."""

    def __init__(
        self,
        model: VideoCaptioningModel,
        config: Config,
        vocabulary: Vocabulary,
        train_loader,
        val_loader,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[Mesh] = None,
    ):
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
        maybe_enable_from_config(config)
        if mesh is None:
            mesh = make_mesh(config, None if distributed() else [self.device])
        self.mesh = mesh
        self.is_chief = mesh.rank == 0
        # Every rank holds the same weights (the same seed): the split takes
        # this rank's block of the vocabulary matrices.
        self.model = sharding.shard_model(model.to(self.device), mesh)
        self.compute_dtype = (torch.bfloat16 if config.training.compute_dtype == "bfloat16"
                              else torch.float32)

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
        self.orbax_manager = None
        if config.experiment.checkpoint_backend == "orbax":
            from ..utils.orbax_ckpt import OrbaxCheckpointManager

            self.orbax_manager = OrbaxCheckpointManager(
                Path(config.experiment.checkpoint_dir) / "orbax")
        # Under the orbax backend (no best_model.pth) the best epoch's
        # evaluation weights, kept on the host for the package.
        self.best_eval_state: Optional[Dict[str, Tensor]] = None
        self.tensorboard_writer = None
        if config.experiment.use_tensorboard and self.is_chief:
            self.tensorboard_writer = create_summary_writer(
                Path(config.experiment.checkpoint_dir) / "tensorboard")

        self.use_wandb = config.experiment.use_wandb and self.is_chief
        self._wandb = None
        if self.use_wandb:
            try:
                import wandb

                wandb.init(project=config.experiment.project_name,
                           name=config.experiment.experiment_name, config=config.to_dict())
                self._wandb = wandb
            except Exception as e:
                self.logger.warning(f"wandb unavailable: {e}")
                self.use_wandb = False

        self.plateau = None
        if config.training.scheduler.lower() == "plateau":
            self.plateau = optim.PlateauScheduler(lr=config.training.learning_rate)

        self.current_epoch = 0
        self.global_step = 0
        self.best_val_score = -float("inf")
        self.patience_counter = 0
        self.train_history: List[Dict[str, Any]] = []
        self.val_history: List[Dict[str, Any]] = []
        # The ranks of a data index draw the same dropout masks.
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.training.seed + mesh.axis_index("data"))

    # ------------------------------------------------------------ steps

    def _place(self, batch: dict) -> Dict[str, Tensor]:
        return place_batch(batch, self.device, self.compute_dtype)

    @contextlib.contextmanager
    def compute_weights(self):
        """The JAX trainer's cast policy for the block: each float32
        parameter of the model reads as its cast to the compute dtype, made
        once on entry by a differentiable ``.to()``, so the gradients land
        on the float32 master copy. The block spans the backward pass too,
        so the attention recomputed there (``training.remat_attention``)
        reads the same casts. A no-op in float32."""
        swapped = []
        if self.compute_dtype != torch.float32:
            for mod in self.model.modules():
                for name, p in list(mod._parameters.items()):
                    if p is not None and p.dtype == torch.float32:
                        swapped.append((mod, name, p))
                        mod._parameters[name] = p.to(self.compute_dtype)
        try:
            yield
        finally:
            for mod, name, p in swapped:
                mod._parameters[name] = p

    def _loss(self, model, feats: Tensor, inp: Tensor, tgt: Tensor, train: bool) -> Tensor:
        out = apply_model(model, self.config, feats, inp, train=train,
                          generator=self.generator if train else None)
        return label_smoothed_cross_entropy(out["logits"], tgt, self.vocabulary.pad_idx,
                                            self.config.training.label_smoothing)

    def _share_loss(self, feats: Tensor, inp: Tensor, tgt: Tensor,
                    global_count: Optional[Tensor] = None) -> Tensor:
        """This rank's share of a data-parallel micro-batch's mean loss: its
        token sum over the token count summed across the data group
        (``global_count``, where the caller has it)."""
        out = apply_model(self.model, self.config, feats, inp, train=True,
                          generator=self.generator)
        total, count = label_smoothed_cross_entropy_terms(
            out["logits"], tgt, self.vocabulary.pad_idx, self.config.training.label_smoothing)
        if global_count is None:
            global_count = count.detach().clone()
            torch.distributed.all_reduce(global_count, group=self.mesh.group("data"))
        return total / global_count.clamp_min(1.0)

    def train_step(self, batch: dict) -> Tensor:
        """One optimizer update on a numpy batch (this rank's rows); returns
        the loss as a device scalar (the mean over micro-batches with
        accumulation; on a mesh, the global batch's, on every rank)."""
        b = self._place(batch)
        parts = (b["video_features"], b["input_tokens"], b["target_tokens"])
        accum = self.config.training.grad_accum_steps
        if parts[0].shape[0] % accum:
            raise ValueError(f"batch of {parts[0].shape[0]} does not split into "
                             f"grad_accum_steps={accum} micro-batches")
        data_parallel = self.mesh.group("data") is not None
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=self.device)
        for micro in zip(*(x.chunk(accum) for x in parts)):
            with self.compute_weights():
                if data_parallel:
                    micro_loss = self._share_loss(*micro)
                else:
                    micro_loss = self._loss(self.model, *micro, train=True)
                (micro_loss / accum).backward()
            loss += micro_loss.detach()
        loss /= accum
        if data_parallel:
            sharding.all_reduce_gradients(self.trainable, self.mesh)
            torch.distributed.all_reduce(loss, group=self.mesh.group("data"))
        clip = self.config.training.gradient_clip_norm
        if clip and clip > 0:
            norm = (sharding.global_grad_norm(list(zip(self.trainable_names, self.trainable)),
                                              self.mesh)
                    if self.mesh.shape["model"] > 1 else None)
            optim.clip_grad_global_norm_(self.trainable, clip, norm)
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

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.config.experiment.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace_epoch0.pt.trace.json"))
        self.logger.info(f"Wrote the profiler trace of epoch 0 to {out}")

    def _epoch_batches(self):
        """(index, batch) of the epoch; under ``experiment.profile_dir``,
        epoch 0's first five steps are traced (the trace also ends with the
        epoch, or where a step raises)."""
        if self.config.experiment.profile_dir is None or self.current_epoch != 0:
            yield from enumerate(self.train_loader)
            return
        prof = self._start_profile()
        try:
            for batch_idx, batch in enumerate(self.train_loader):
                yield batch_idx, batch
                if batch_idx == 4:
                    self._stop_profile(prof)
                    prof = None
        finally:
            if prof is not None:
                self._stop_profile(prof)

    def train_epoch(self) -> Dict[str, float]:
        batches = self._epoch_batches()
        try:
            return self._train_batches(batches)
        finally:
            batches.close()  # ends a trace at once where a step raised

    def _train_batches(self, batches) -> Dict[str, float]:
        self.model.train()
        total_loss = 0.0
        num_batches = len(self.train_loader)
        self.train_loader.set_epoch(self.current_epoch)
        pending_loss = None
        bad_steps = 0
        max_bad = self.config.training.max_bad_steps
        for batch_idx, batch in batches:
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
                if self.use_wandb:
                    self._wandb.log({"train/batch_loss": loss_val, "train/learning_rate": lr,
                                     "global_step": self.global_step})
        if pending_loss is not None:
            total_loss += float(pending_loss)
        return {"loss": total_loss / max(num_batches, 1)}

    def eval_state_dict(self) -> Dict[str, Tensor]:
        """The weights validation and export use: the EMA shadow when
        ``training.ema_decay`` is on, the model's own otherwise."""
        return self.ema if self.ema is not None else self.model.state_dict()

    def _eval_target(self) -> VideoCaptioningModel:
        """The model validation runs: the trained one itself, or a copy in
        the compute dtype holding the EMA shadow or the weights."""
        if self.ema is None and self.compute_dtype == torch.float32:
            return self.model
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model).to(self.compute_dtype)
        self._eval_model.load_state_dict(self.eval_state_dict())
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
        if self.orbax_manager is not None:
            self.orbax_manager.wait()
        if self.is_chief:
            with open(Path(self.config.experiment.checkpoint_dir) / "training_results.json",
                      "w") as f:
                json.dump(results, f, indent=2)
        if self.tensorboard_writer:
            self.tensorboard_writer.close()
        if self.use_wandb:
            self._wandb.finish()
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
        if self.tensorboard_writer:
            self.tensorboard_writer.add_scalar("Train/EpochLoss", train_metrics["loss"], epoch)
            self.tensorboard_writer.add_scalar("Val/EpochLoss", val_metrics["loss"], epoch)
            for name, value in val_metrics.items():
                if name != "loss":
                    self.tensorboard_writer.add_scalar(f"Val/{name}", value, epoch)
        if self.use_wandb:
            self._wandb.log({"train/epoch_loss": train_metrics["loss"],
                             "val/epoch_loss": val_metrics["loss"],
                             **{f"val/{k}": v for k, v in val_metrics.items() if k != "loss"},
                             "epoch": epoch})

    def _full_optimizer_state(self) -> Dict[str, Any]:
        """The optimizer's state dict with each split parameter's state
        gathered over the model group (a collective on a split model)."""
        state = self.optimizer.state_dict()
        if self.mesh.shape["model"] == 1:
            return state
        split = set(sharding.split_names(self.model))
        full = {}
        for idx, entry in state["state"].items():
            if self.trainable_names[idx] in split:
                entry = {k: sharding.gather_rows(v, self.mesh)
                         if isinstance(v, Tensor) and v.ndim else v for k, v in entry.items()}
            full[idx] = entry
        return dict(state, state=full)

    def _local_optimizer_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """``_full_optimizer_state``'s inverse: this rank's block of each
        split parameter's state."""
        if self.mesh.shape["model"] == 1:
            return state
        split = set(sharding.split_names(self.model))
        local = {}
        for idx, entry in state["state"].items():
            if self.trainable_names[int(idx)] in split:
                entry = {k: sharding.local_rows(v, self.mesh)
                         if isinstance(v, Tensor) and v.ndim else v for k, v in entry.items()}
            local[int(idx)] = entry
        return dict(state, state=local)

    def _optimizer_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "format": OPTIMIZER_FORMAT,
            "optimizer": type(self.optimizer).__name__,
            "param_names": list(self.trainable_names),
            "state": _to_numpy(state),
        }

    def _check_optimizer(self, optimizer: str, names: List[str], where) -> None:
        if optimizer != type(self.optimizer).__name__ or list(names) != self.trainable_names:
            raise ValueError(f"{where}: saved with a different optimizer "
                             f"({optimizer}, {len(names)} trainable tensors); resume with the "
                             "training config used at save time")

    def _save(self, epoch: int, metrics: Dict[str, float], is_best: bool) -> None:
        """Every rank calls it (a split model gathers its blocks); rank 0
        writes."""
        params = sharding.gather_state_dict(self.model.state_dict(), self.mesh)
        ema = None if self.ema is None else sharding.gather_state_dict(self.ema, self.mesh)
        opt_state = self._full_optimizer_state()
        if not self.is_chief:
            return
        additional = {"global_step": self.global_step, "best_val_score": self.best_val_score}
        if self.orbax_manager is not None:
            if is_best:
                self.best_eval_state = {k: v.detach().cpu().clone()
                                        for k, v in (ema if ema is not None else params).items()}
            self.orbax_manager.save(
                epoch, params, opt_state, metrics=metrics,
                extra={**additional, "optimizer": type(self.optimizer).__name__,
                       "param_names": list(self.trainable_names)},
                ema_params=ema)
            return
        best_state = None
        if ema is not None:
            best_state = additional["ema_state_dict"] = jax_params_from_state_dict(
                ema, self.config)
        self.checkpoint_manager.save_checkpoint(
            jax_params_from_state_dict(params, self.config),
            self._optimizer_state(opt_state),
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

    def _load_params(self, state: Dict[str, Tensor]) -> None:
        """Load unsplit parameters (this rank's block of the split ones)."""
        self.model.load_state_dict(sharding.local_state_dict(
            {k: v.to(self.device) for k, v in state.items()}, self.mesh))

    def _local_ema(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return sharding.local_state_dict({k: v.to(self.device).float()
                                          for k, v in state.items()}, self.mesh)

    def load_orbax_checkpoint(self, epoch: Optional[int] = None) -> None:
        """Resume from the orbax backend (latest epoch by default): the
        parameters, the optimizer state and the EMA exactly as saved; a
        different optimizer configuration is refused."""
        if self.orbax_manager is None:
            raise RuntimeError("orbax backend not enabled")
        restored = self.orbax_manager.restore(epoch)
        meta = restored["meta"]
        self._check_optimizer(meta["optimizer"], meta["param_names"],
                              self.orbax_manager.checkpoint_dir)
        self._load_params(restored["params"])
        self.optimizer.load_state_dict(self._local_optimizer_state(
            _to_torch_tensors(restored["opt_state"], self.device)))
        if self.ema is not None:
            self.ema = self._local_ema(restored.get("ema_params", restored["params"]))
        self.current_epoch = int(meta["epoch"])
        self.global_step = int(meta["global_step"])
        self.best_val_score = float(meta["best_val_score"])
        self.logger.info(f"Loaded orbax-backend checkpoint from epoch {self.current_epoch}")

    def _state_dict_on_device(self, params) -> Dict[str, Tensor]:
        return {k: v.to(self.device) for k, v in
                state_dict_from_jax_params(params, self.config).items()}

    def load_checkpoint(self, checkpoint_path: Path) -> Dict[str, Any]:
        """Resume from a training checkpoint that either package wrote (the
        JAX trainer's optax state converted by ``optim.torch_state_from_optax``)."""
        checkpoint = self.checkpoint_manager.load_checkpoint(checkpoint_path)
        opt = checkpoint["optimizer_state_dict"]
        raw = checkpoint.get("raw_model_state_dict", checkpoint["model_state_dict"])
        if isinstance(opt, dict) and opt.get("format") == OPTIMIZER_FORMAT:
            self._check_optimizer(opt["optimizer"], opt["param_names"], checkpoint_path)
            opt_state = _to_torch(opt["state"])
        elif isinstance(opt, (tuple, OptaxState)):  # the JAX trainer's optax state
            opt_state = optim.torch_state_from_optax(opt, raw, self.config, self.trainable_names,
                                                     self.optimizer)
        else:
            raise ValueError(f"{checkpoint_path}: the optimizer state is neither "
                             f"{OPTIMIZER_FORMAT!r} nor an optax state of the JAX trainer")
        self._load_params(self._state_dict_on_device(raw))
        self.optimizer.load_state_dict(self._local_optimizer_state(opt_state))
        if self.plateau is not None and "scheduler_state_dict" in checkpoint:
            self.plateau.load_state_dict(checkpoint["scheduler_state_dict"])
        if self.ema is not None:
            src = checkpoint.get("ema_state_dict", raw)  # no EMA saved: restart it
            self.ema = self._local_ema(self._state_dict_on_device(src))
        self.current_epoch = checkpoint["epoch"]
        self.global_step = checkpoint.get("global_step", 0)
        self.best_val_score = checkpoint.get("best_val_score", -float("inf"))
        self.logger.info(f"Loaded checkpoint from epoch {self.current_epoch}")
        return checkpoint
