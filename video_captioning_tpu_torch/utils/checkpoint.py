"""Training checkpoints and inference packages in the JAX package's schema,
read and written without JAX.

Counterpart of video_captioning_tpu/utils/checkpoint.py.

* An inference package is a pickled dict: ``model_state_dict`` (the JAX
  parameter pytree as numpy arrays), ``model_config`` (``Config.to_dict()``),
  ``vocabulary`` (word2idx, idx2word, special tokens) and ``model_info``,
  with a ``model_config.json`` sidecar. A package written by either
  package loads in the other.
* ``CheckpointManager`` writes ``checkpoint_epoch_{NNNN}.pth`` with
  ``best_model.pth`` and ``latest_checkpoint.pth`` mirrors and keeps the
  last 5, with the same keys: ``epoch``, ``model_state_dict`` (the JAX
  pytree, through ``models.weights.jax_params_from_state_dict``),
  ``optimizer_state_dict``, ``metrics``, ``model_config``. The optimizer
  state is the port's own (``torch.optim`` state with numpy arrays, marked
  by ``OPTIMIZER_FORMAT``), so resuming reads only checkpoints the port
  wrote. A JAX-written training checkpoint pickles optax types: reading one
  here is refused with an error instead of importing optax.
"""

from __future__ import annotations

import json
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..config import Config
from ..data.vocabulary import Vocabulary

OPTIMIZER_FORMAT = "video_captioning_tpu_torch.optim/1"
_JAX_MODULES = ("jax", "jaxlib", "optax", "chex", "flax", "orbax")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class _NoJaxUnpickler(pickle.Unpickler):
    """Refuses the types of the JAX stack instead of importing them."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _JAX_MODULES:
            raise ValueError(
                f"this file holds {module}.{name}: it was written by the JAX package "
                "(its optimizer state is optax's); video_captioning_tpu_torch resumes "
                "only training checkpoints it wrote, and reads inference packages of "
                "either package"
            )
        return super().find_class(module, name)


def _load(path: Path) -> Dict[str, Any]:
    """Unpickling runs code: load only files that this project wrote."""
    with open(path, "rb") as f:
        return _NoJaxUnpickler(f).load()


def _dump(obj: Any, path: Path) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)  # atomic: no torn files on kill


def _package(params: Dict[str, Any], vocabulary: Vocabulary, config: Config) -> Dict[str, Any]:
    return {
        "model_state_dict": params,
        "model_config": config.to_dict(),
        "vocabulary": {
            "word2idx": vocabulary.word2idx,
            "idx2word": vocabulary.idx2word,
            "special_tokens": {
                "pad_token": vocabulary.pad_token,
                "start_token": vocabulary.start_token,
                "end_token": vocabulary.end_token,
                "unk_token": vocabulary.unk_token,
                "pad_idx": vocabulary.pad_idx,
                "start_idx": vocabulary.start_idx,
                "end_idx": vocabulary.end_idx,
                "unk_idx": vocabulary.unk_idx,
            },
        },
        "model_info": {
            "vocab_size": len(vocabulary),
            "trainable_parameters": sum(int(np.asarray(x).size) for x in _leaves(params)),
        },
    }


def save_model_for_inference(
    params: Dict[str, Any],
    vocabulary: Vocabulary,
    config: Config,
    checkpoint_dir: Path,
    model_name: str = "model_for_inference.pth",
) -> Path:
    """Write ``params`` (a JAX-layout pytree of numpy arrays) as an
    inference package in ``checkpoint_dir``; returns its path."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoint_dir / model_name
    _dump(_package(params, vocabulary, config), path)
    with open(checkpoint_dir / "model_config.json", "w", encoding="utf-8") as f:
        json.dump(config.to_dict(), f, indent=2)
    return path


def load_model_for_inference(model_path: Path) -> Dict[str, Any]:
    """Read a package written by either package."""
    model_path = Path(model_path)
    if not model_path.exists():
        raise FileNotFoundError(f"Inference model not found: {model_path}")
    return _load(model_path)


def vocabulary_from_package(package: Dict[str, Any], config: Config) -> Vocabulary:
    vocab_data = package["vocabulary"]
    vocab = Vocabulary(config)
    vocab.word2idx = dict(vocab_data["word2idx"])
    vocab.idx2word = {int(k): v for k, v in vocab_data["idx2word"].items()}
    special = vocab_data["special_tokens"]
    vocab.pad_idx = special["pad_idx"]
    vocab.start_idx = special["start_idx"]
    vocab.end_idx = special["end_idx"]
    vocab.unk_idx = special["unk_idx"]
    return vocab


class CheckpointManager:
    """Save and load training checkpoints and inference packages."""

    def __init__(self, checkpoint_dir: Path):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.logger = logging.getLogger(__name__)

    def save_checkpoint(
        self,
        params: Dict[str, Any],
        optimizer_state: Dict[str, Any],
        epoch: int,
        metrics: Dict[str, float],
        *,
        scheduler_state: Optional[dict] = None,
        config: Optional[Config] = None,
        is_best: bool = False,
        additional_info: Optional[Dict[str, Any]] = None,
        best_model_state: Optional[Dict[str, Any]] = None,
    ) -> Path:
        """``params``: the JAX-layout numpy pytree. With ``is_best`` and
        ``best_model_state`` (the EMA weights that earned the score),
        ``best_model.pth`` stores that tree as its ``model_state_dict`` and
        the raw parameters under ``raw_model_state_dict``."""
        checkpoint = {
            "epoch": epoch,
            "model_state_dict": params,
            "optimizer_state_dict": optimizer_state,
            "metrics": metrics,
            "model_config": config.to_dict() if config is not None else None,
        }
        if scheduler_state is not None:
            checkpoint["scheduler_state_dict"] = scheduler_state
        if additional_info:
            checkpoint.update(additional_info)

        path = self.checkpoint_dir / f"checkpoint_epoch_{epoch:04d}.pth"
        _dump(checkpoint, path)
        if is_best:
            best = checkpoint
            if best_model_state is not None:
                best = dict(checkpoint, model_state_dict=best_model_state,
                            raw_model_state_dict=params)
            _dump(best, self.checkpoint_dir / "best_model.pth")
            self.logger.info(f"Saved best model at epoch {epoch}")
        _dump(checkpoint, self.checkpoint_dir / "latest_checkpoint.pth")
        self.logger.info(f"Saved checkpoint at epoch {epoch}")
        self._cleanup_old_checkpoints()
        return path

    def load_checkpoint(self, checkpoint_path: Path) -> Dict[str, Any]:
        checkpoint_path = Path(checkpoint_path)
        if not checkpoint_path.exists():
            raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
        checkpoint = _load(checkpoint_path)
        self.logger.info(f"Loaded checkpoint from {checkpoint_path}")
        return checkpoint

    def load_best_model(self) -> Optional[Dict[str, Any]]:
        path = self.checkpoint_dir / "best_model.pth"
        if path.exists():
            return self.load_checkpoint(path)
        self.logger.warning("Best model checkpoint not found")
        return None

    def list_checkpoints(self) -> list:
        return sorted(self.checkpoint_dir.glob("checkpoint_epoch_*.pth"))

    def _cleanup_old_checkpoints(self, keep_last: int = 5) -> None:
        for old in self.list_checkpoints()[:-keep_last]:
            try:
                old.unlink()
            except OSError as e:
                self.logger.warning(f"Failed to remove checkpoint {old}: {e}")

    def save_model_for_inference(self, params: Dict[str, Any], vocabulary: Vocabulary,
                                 config: Config,
                                 model_name: str = "model_for_inference.pth") -> Path:
        path = save_model_for_inference(params, vocabulary, config, self.checkpoint_dir,
                                        model_name)
        self.logger.info(f"Saved inference model to {path}")
        return path
