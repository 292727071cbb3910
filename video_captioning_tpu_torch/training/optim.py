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

:func:`torch_state_from_optax` turns the optax state of a JAX-written
checkpoint (read as ``utils.checkpoint.OptaxState`` stand-ins) into the
torch optimizer's: Adam's and AdamW's ``count``, ``mu`` and ``nu`` become
``step``, ``exp_avg`` and ``exp_avg_sq``, SGD's trace the
``momentum_buffer``, and the injected learning rate the group's ``lr``.
The moment trees are in the JAX parameter layout and go through the
weight bridge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..models.weights import state_dict_from_jax_params
from ..utils.checkpoint import OptaxState


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
def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float,
                           norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on the gradients; returns the
    norm before clipping (``norm``, where the caller has the norm of a
    gradient split over processes). No host sync: the choice is made on
    the device."""
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    if norm is None:
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


def _find_states(tree: Any, kinds: Sequence[str]) -> List[OptaxState]:
    """The optax states of ``kinds`` in the tree, in order."""
    found: List[OptaxState] = []
    if isinstance(tree, OptaxState):
        if tree.kind in kinds:
            found.append(tree)
        for field in tree:
            found += _find_states(field, kinds)
    elif isinstance(tree, (list, tuple)):
        for field in tree:
            found += _find_states(field, kinds)
    elif isinstance(tree, dict):
        for field in tree.values():
            found += _find_states(field, kinds)
    return found


def _fill_masked(tree: Any, params: Any) -> Any:
    """The moment tree with each ``MaskedNode`` (a frozen parameter's
    place under ``freeze_encoder``) replaced by zeros of the parameter's
    shape, so that the bridge can map it whole."""
    if isinstance(tree, OptaxState) and tree.kind == "MaskedNode":
        return np.zeros_like(np.asarray(params, np.float32))
    if isinstance(tree, dict):
        return {k: _fill_masked(v, params[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fill_masked(v, p) for v, p in zip(tree, params)]
    return tree


def torch_state_from_optax(opt_state: Any, params: Mapping, config: Config,
                           names: Sequence[str], optimizer: torch.optim.Optimizer
                           ) -> Dict[str, Any]:
    """A ``state_dict`` for ``optimizer`` (over the trainable parameters
    ``names``, in order) holding the optax state of a JAX-written
    checkpoint; ``params`` is that checkpoint's parameter tree."""
    name = config.training.optimizer.lower()
    kind = {"adam": "ScaleByAdamState", "adamw": "ScaleByAdamState",
            "sgd": "TraceState"}[name]
    states = _find_states(opt_state, (kind,))
    injected = _find_states(opt_state, ("InjectHyperparamsState",
                                        "InjectStatefulHyperparamsState"))
    if len(states) != 1 or len(injected) != 1:
        raise ValueError(f"the checkpoint's optimizer state is not the JAX trainer's "
                         f"{name} chain (found {len(states)} {kind}, {len(injected)} "
                         "injected hyperparameter states)")

    def by_name(tree) -> Dict[str, torch.Tensor]:
        return state_dict_from_jax_params(_fill_masked(tree, params), config)

    if kind == "ScaleByAdamState":
        count, mu, nu = states[0]
        mu, nu = by_name(mu), by_name(nu)
        step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
        per_param = [{"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                     for n in names]
    else:
        trace = by_name(states[0][0])
        per_param = [{"momentum_buffer": trace[n]} for n in names]
    lr = float(np.asarray(injected[0][1]["learning_rate"]))
    sd = optimizer.state_dict()
    groups = [dict(g, lr=lr) for g in sd["param_groups"]]
    ids = [i for g in groups for i in g["params"]]
    return {"state": dict(zip(ids, per_param)), "param_groups": groups}


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
