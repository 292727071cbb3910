"""The ``checkpoint_backend="orbax"`` backend on ``torch.distributed.checkpoint``.

Counterpart of video_captioning_tpu/utils/orbax_ckpt.py
(``OrbaxCheckpointManager``): asynchronous saves (training continues while
a checkpoint lands), the last ``keep_last`` epochs kept, the latest or a
named epoch restored, a missing one raising ``FileNotFoundError``. The
config value keeps its JAX name so ``model_config`` dicts move between the
packages; the files are PyTorch's. Each epoch is a directory
``<checkpoint_dir>/<epoch>`` holding the ``torch.distributed.checkpoint``
files of ``{"params", "opt_state", "ema_params"}`` (tensors) and
``manifest.json`` (the epoch, metrics, extra values and the layout of the
optimizer state), written once the tensors are durable: a directory
without it is not a checkpoint.

A JAX orbax directory holds tensorstore arrays that only orbax reads; it
is refused with a message that says so.
"""

from __future__ import annotations

import json
import logging
import shutil
import warnings
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed.checkpoint as dcp

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
FORMAT = "vct-torch-dcp-v1"
# Files orbax writes into a step directory (and this backend never does).
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding")


def _flatten_optimizer(state: Dict[str, Any]):
    """An optimizer ``state_dict`` as (flat tensors, JSON layout)."""
    tensors, layout = {}, {}
    for idx, entry in state["state"].items():
        layout[str(idx)] = {}
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                tensors[f"{idx}.{key}"] = value
                layout[str(idx)][key] = {"shape": list(value.shape),
                                         "dtype": str(value.dtype).removeprefix("torch.")}
            else:
                layout[str(idx)][key] = {"value": value}
    return tensors, {"state": layout, "param_groups": state["param_groups"]}


def _tensor_template(layout: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{idx}.{key}": torch.empty(spec["shape"], dtype=getattr(torch, spec["dtype"]))
            for idx, entry in layout["state"].items()
            for key, spec in entry.items() if "shape" in spec}


def _unflatten_optimizer(tensors: Dict[str, torch.Tensor], layout: Dict[str, Any]):
    state = {}
    for idx, entry in layout["state"].items():
        state[int(idx)] = {key: tensors[f"{idx}.{key}"] if "shape" in spec else spec["value"]
                           for key, spec in entry.items()}
    return {"state": state, "param_groups": layout["param_groups"]}


def refuse_jax_orbax(path: Path) -> None:
    """Raise for a directory that the JAX package's orbax backend wrote."""
    if any((path / m).exists() for m in ORBAX_MARKERS) and not (path / MANIFEST).exists():
        raise ValueError(
            f"{path} is an orbax checkpoint written by the JAX package; reading it needs "
            "orbax and tensorstore, which video_captioning_tpu_torch does not use. Resume "
            "from the JAX trainer's native checkpoint (checkpoint_backend='native') instead")


class OrbaxCheckpointManager:
    """Async, keep-last-N checkpoints over ``torch.distributed.checkpoint``.
    Every save is written by this process alone (``no_dist``): under a
    process group the trainer calls it on rank 0 only."""

    def __init__(self, checkpoint_dir: Path, keep_last: int = 5):
        self.checkpoint_dir = Path(checkpoint_dir).absolute()
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._pending: List[tuple] = []

    # ------------------------------------------------------------- saving

    def save(self, epoch: int, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None, extra: Optional[Dict[str, Any]] = None,
             ema_params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Queue epoch ``epoch``: the tensors are staged to host memory
        before this returns, and written by a background thread. A save
        still in flight finishes first (as orbax's manager does), so a
        second save of the same epoch replaces a complete one."""
        self.wait()
        opt_tensors, opt_layout = _flatten_optimizer(opt_state)
        state = {"params": dict(params), "opt_state": opt_tensors}
        if ema_params is not None:
            state["ema_params"] = dict(ema_params)
        manifest = {
            "format": FORMAT,
            "epoch": int(epoch),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()
                        if isinstance(v, (int, float))},
            "extra": {k: v for k, v in (extra or {}).items()
                      if isinstance(v, (int, float, str, list))},
            "opt_layout": opt_layout,
            "has_ema": ema_params is not None,
        }
        step_dir = self.checkpoint_dir / str(epoch)
        if step_dir.exists():
            shutil.rmtree(step_dir)
        with warnings.catch_warnings():  # no_dist: "assuming ... a single process"
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            future = dcp.async_save(state, checkpoint_id=str(step_dir), no_dist=True)
        self._pending.append((future, step_dir, manifest))
        logger.info(f"Queued orbax-backend checkpoint for epoch {epoch} (async)")

    def wait(self) -> None:
        """Block until queued saves are durable, then prune to the last
        ``keep_last`` epochs."""
        pending, self._pending = self._pending, []
        for future, step_dir, manifest in pending:
            if isinstance(future, Future):
                future.result()
            (step_dir / MANIFEST).write_text(json.dumps(manifest, indent=2))
        for epoch in self.all_epochs()[:-self.keep_last or None]:
            shutil.rmtree(self.checkpoint_dir / str(epoch))

    # ----------------------------------------------------------- restoring

    def all_epochs(self) -> List[int]:
        return sorted(int(p.name) for p in self.checkpoint_dir.iterdir()
                      if p.name.isdigit() and (p / MANIFEST).exists())

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """``{"params", "opt_state", "meta", "metrics"[, "ema_params"]}`` of
        ``epoch`` (default: the latest), tensors on the CPU."""
        self.wait()
        for p in [self.checkpoint_dir, *self.checkpoint_dir.iterdir()]:
            if p.is_dir():
                refuse_jax_orbax(p)
        step = epoch if epoch is not None else self.latest_epoch()
        step_dir = self.checkpoint_dir / str(step)
        if step is None or not (step_dir / MANIFEST).exists():
            raise FileNotFoundError(f"No orbax-backend checkpoint"
                                    f"{'' if step is None else f' for epoch {step}'} in "
                                    f"{self.checkpoint_dir}")
        manifest = json.loads((step_dir / MANIFEST).read_text())
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{step_dir} is not a {FORMAT} checkpoint")
        layout = manifest["opt_layout"]
        template: Dict[str, Any] = {"opt_state": _tensor_template(layout)}
        md = dcp.FileSystemReader(str(step_dir)).read_metadata()
        for key, item in md.state_dict_metadata.items():
            top, _, rest = key.partition(".")
            if top in ("params", "ema_params"):
                template.setdefault(top, {})[rest] = torch.empty(tuple(item.size),
                                                                 dtype=item.properties.dtype)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            dcp.load(template, checkpoint_id=str(step_dir), no_dist=True)
        restored = {
            "params": template["params"],
            "opt_state": _unflatten_optimizer(template["opt_state"], layout),
            "meta": {"epoch": manifest["epoch"], **manifest["extra"]},
            "metrics": manifest["metrics"],
        }
        if "ema_params" in template:
            restored["ema_params"] = template["ema_params"]
        logger.info(f"Restored orbax-backend checkpoint for epoch {step}")
        return restored

    def close(self) -> None:
        self.wait()
