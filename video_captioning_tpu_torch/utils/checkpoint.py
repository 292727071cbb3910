"""Inference packages: the JAX package's pickle schema, read and written
without JAX.

Counterpart of video_captioning_tpu/utils/checkpoint.py
(save_model_for_inference / load_model_for_inference). A package is a
pickled dict: ``model_state_dict`` (the JAX parameter pytree as numpy
arrays), ``model_config`` (``Config.to_dict()``), ``vocabulary``
(word2idx, idx2word, special tokens) and ``model_info``, with a
``model_config.json`` sidecar. A package written by either package loads
in the other.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    package = {
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
    path = checkpoint_dir / model_name
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(package, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    with open(checkpoint_dir / "model_config.json", "w", encoding="utf-8") as f:
        json.dump(config.to_dict(), f, indent=2)
    return path


def load_model_for_inference(model_path: Path) -> Dict[str, Any]:
    """Read a package. Unpickling runs code: load only packages that this
    project wrote."""
    model_path = Path(model_path)
    if not model_path.exists():
        raise FileNotFoundError(f"Inference model not found: {model_path}")
    with open(model_path, "rb") as f:
        return pickle.load(f)


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
