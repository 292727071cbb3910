"""Optimizers, gradient clipping and LR schedules.

Counterpart of video_captioning_tpu/training/optim.py, whose optax chains
reproduce torch's update rules; the port therefore calls ``torch.optim``:

* ``adam``  -> ``torch.optim.Adam(weight_decay=wd)``: L2 decay added to the
  gradient before the moments (optax ``add_decayed_weights`` then
  ``scale_by_adam``),
* ``adamw`` -> ``torch.optim.AdamW(weight_decay=wd)``: decoupled decay,
* ``sgd``   -> ``torch.optim.SGD(momentum=0.9, weight_decay=wd)``.

Clipping is optax's ``clip_by_global_norm``: when the global norm n of
the gradients reaches ``max_norm`` each gradient becomes g / n * max_norm
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to n; this does not). With
``freeze_encoder`` the encoder's parameters are left out of the
optimizer, so, as under optax's ``multi_transform``, they get no update
and the norm is taken over the decoder's gradients only.

Schedules are stepped per epoch: ``cosine`` and ``step`` through
:func:`lr_at_epoch`, ``plateau`` through :class:`PlateauScheduler`; the
trainer writes the learning rate into the optimizer's ``param_groups``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch

from ..config import Config


def build_optimizer(params: Iterable[torch.nn.Parameter], config: Config) -> torch.optim.Optimizer:
    """The configured optimizer over ``params`` (the trainable ones)."""
    name = config.training.optimizer.lower()
    lr = config.training.learning_rate
    wd = config.training.weight_decay
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=wd)
    raise ValueError(f"Unsupported optimizer: {config.training.optimizer}")


@torch.no_grad()
def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on the gradients; returns the
    norm before clipping. No host sync: the choice is made on the device."""
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def lr_at_epoch(config: Config, epoch: int) -> Optional[float]:
    """LR after ``epoch`` scheduler steps for the cosine and step
    schedules; None for plateau and none."""
    base = config.training.learning_rate
    n = config.training.num_epochs
    sched = config.training.scheduler.lower()
    if sched == "cosine":
        eta_min = base * 0.01
        return eta_min + (base - eta_min) * (1 + math.cos(math.pi * epoch / n)) / 2
    if sched == "step":
        step_size = max(n // 3, 1)
        return base * (0.1 ** (epoch // step_size))
    return None


@dataclass
class PlateauScheduler:
    """torch ReduceLROnPlateau(mode='max', factor=0.5, patience=5) parity."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    best: float = -math.inf
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric > self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr, "factor": self.factor, "patience": self.patience,
            "best": self.best, "num_bad": self.num_bad,
        }

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
