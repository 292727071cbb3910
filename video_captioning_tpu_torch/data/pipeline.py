"""Host-side input pipeline, without pandas or scikit-learn.

Counterpart of video_captioning_tpu/data/pipeline.py: the same examples,
batches and splits.

* ``prepare_data`` reads the captions CSV with the ``csv`` module, drops
  rows whose feature file is missing, and splits 3 ways as the JAX package
  does with scikit-learn's ``train_test_split(test_size=..,
  random_state=42)`` twice. That function is a ``ShuffleSplit``:
  ``n_test = ceil(test_size * n)``, ``perm = RandomState(42).permutation(n)``,
  test = the rows at ``perm[:n_test]``, train = those at ``perm[n_test:]``,
  in that order. A split is a list of CSV rows (dicts).
* Features are uniformly resampled or zero-padded to ``frames_per_video``;
  captions are encoded, shifted into (input, target) and PAD-padded to
  ``max_sequence_length``.
* ``DataLoader`` yields numpy batches with the JAX package's per-epoch
  ``RandomState(seed + epoch)`` shuffle and drop-last, with a bounded
  prefetch queue. A batch's features load through the native C++ loader
  (``native.load_features_batch``: the whole batch in one call, files read
  in parallel outside the GIL) where it takes the files, and otherwise one
  ``.npy`` at a time on worker threads, as the JAX package's
  ``get_batch`` does.
* ``place_batch`` puts a batch's arrays on the device, casting the
  features on the host first where training computes in bfloat16 (the JAX
  trainer's ``_place``: half the bytes cross to the device; the values are
  those of a cast on the device).
"""

from __future__ import annotations

import csv
import logging
import math
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..native import load_features_batch
from .vocabulary import Vocabulary

logger = logging.getLogger(__name__)

Row = Dict[str, str]


def resample_features(features: np.ndarray, target_len: int) -> np.ndarray:
    """Uniformly resample or zero-pad a (T, F) feature array to target_len."""
    n = len(features)
    if n > target_len:
        idx = np.linspace(0, n - 1, target_len, dtype=int)
        return features[idx]
    if n < target_len:
        pad = np.zeros((target_len - n, features.shape[1]), dtype=features.dtype)
        return np.vstack([features, pad])
    return features


def pad_tokens(seq: List[int], max_length: int, pad_idx: int) -> List[int]:
    if len(seq) > max_length:
        return seq[:max_length]
    return seq + [pad_idx] * (max_length - len(seq))


class VideoCaptioningDataset:
    """Feature-file dataset: one row = (video_id, feature_path, caption)."""

    def __init__(self, rows: Sequence[Row], vocabulary: Vocabulary, config: Config,
                 split: str = "train"):
        self.vocabulary = vocabulary
        self.config = config
        self.split = split
        self.native_batches = 0
        self.rows = [r for r in rows if os.path.exists(r["feature_path"])]
        if len(self.rows) != len(rows):
            logger.warning(f"{len(rows) - len(self.rows)} feature files not found; dropping rows")

    def __len__(self) -> int:
        return len(self.rows)

    def _encode_tokens(self, caption: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        token_ids = self.vocabulary.encode_caption(caption)
        max_len = self.config.model.max_sequence_length
        pad = self.vocabulary.pad_idx
        input_tokens = np.asarray(pad_tokens(token_ids[:-1], max_len, pad), np.int32)
        target_tokens = np.asarray(pad_tokens(token_ids[1:], max_len, pad), np.int32)
        return input_tokens, target_tokens, (input_tokens != pad).astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        row = self.rows[idx]
        features = np.load(row["feature_path"]).astype(np.float32)
        features = resample_features(features, self.config.data.frames_per_video)
        input_tokens, target_tokens, caption_mask = self._encode_tokens(row["caption"])
        return {
            "video_features": features,
            "input_tokens": input_tokens,
            "target_tokens": target_tokens,
            "caption_mask": caption_mask,
            "video_id": row.get("video_id", f"video_{idx}"),
            "caption_text": row["caption"],
        }

    def get_batch(self, indices: Sequence[int], pool=None) -> Dict[str, object]:
        """A whole batch: the features through the native loader in one
        call, the tokens encoded here; where the loader does not take the
        files, the items one at a time (over ``pool`` when given).
        ``native_batches`` counts the batches the native path served."""
        rows = [self.rows[int(i)] for i in indices]
        features = load_features_batch([r["feature_path"] for r in rows],
                                       self.config.data.frames_per_video,
                                       self.config.model.cnn_feature_dim)
        if features is None:
            idx = [int(i) for i in indices]
            return _collate(list(pool.map(self.__getitem__, idx)) if pool is not None
                            else [self[i] for i in idx])
        self.native_batches += 1
        toks = [self._encode_tokens(r["caption"]) for r in rows]
        return {
            "video_features": features,
            "input_tokens": np.stack([t[0] for t in toks]),
            "target_tokens": np.stack([t[1] for t in toks]),
            "caption_mask": np.stack([t[2] for t in toks]),
            "video_id": [r.get("video_id", f"video_{i}") for i, r in zip(indices, rows)],
            "caption_text": [r["caption"] for r in rows],
        }


def _collate(items: List[Dict[str, object]]) -> Dict[str, object]:
    batch: Dict[str, object] = {}
    for key in ("video_features", "input_tokens", "target_tokens", "caption_mask"):
        batch[key] = np.stack([it[key] for it in items])
    batch["video_id"] = [it["video_id"] for it in items]
    batch["caption_text"] = [it["caption_text"] for it in items]
    return batch


class DataLoader:
    """Batched iterator with worker-thread loading and a bounded prefetch.

    Sharding: with ``num_shards > 1`` (data-parallel processes) each
    process reads the strided slice ``idx[shard_index::num_shards]`` of
    the (shuffled) index list, so the processes' batches are disjoint;
    batches of that slice come in order, through the native loader or the
    Python one alike."""

    def __init__(self, dataset: VideoCaptioningDataset, batch_size: int, *,
                 shuffle: bool = False, drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 42, shard_index: int = 0, num_shards: int = 1):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} is not in [0, {num_shards})")
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(range(self.shard_index, len(self.dataset), self.num_shards))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        end = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        for start in range(0, end, self.batch_size):
            yield idx[start: start + self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, object]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # set when the consumer abandons iteration

        def put(obj) -> bool:
            # A bounded put that gives up once the consumer is gone.
            while not stop.is_set():
                try:
                    out_q.put(obj, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batches():
                        if stop.is_set() or not put(self.dataset.get_batch(batch_idx, pool)):
                            return
            except Exception as e:  # surface loader errors to the consumer
                put(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:  # unblock a producer stuck on a full queue
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5)


def place_batch(batch: Dict[str, object], device: torch.device,
                feature_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``; the features cast to
    ``feature_dtype`` on the host before the copy."""
    out = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    if feature_dtype != torch.float32 and "video_features" in out:
        out["video_features"] = out["video_features"].to(feature_dtype)
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


def create_data_loaders(
    config: Config,
    vocabulary: Vocabulary,
    train_rows: Sequence[Row],
    val_rows: Sequence[Row],
    test_rows: Optional[Sequence[Row]] = None,
    *,
    shard_index: int = 0,
    num_shards: int = 1,
    batch_size: Optional[int] = None,
) -> Tuple[DataLoader, DataLoader, Optional[DataLoader]]:
    """Train shuffles and drops the ragged tail; val and test do not. Each
    loader reads shard ``shard_index`` of ``num_shards``, ``batch_size``
    rows a batch (default ``training.batch_size``)."""
    common = dict(num_workers=config.training.num_workers,
                  prefetch=config.training.prefetch_batches, seed=config.training.seed,
                  shard_index=shard_index, num_shards=num_shards)
    bs = batch_size or config.training.batch_size

    def loader(rows, split, train):
        return DataLoader(VideoCaptioningDataset(rows, vocabulary, config, split=split), bs,
                          shuffle=train, drop_last=train, **common)

    test = None if test_rows is None else loader(test_rows, "test", False)
    return loader(train_rows, "train", True), loader(val_rows, "val", False), test


def shuffle_split(rows: Sequence[Row], test_size: float,
                  seed: int = 42) -> Tuple[List[Row], List[Row]]:
    """scikit-learn's ``train_test_split(rows, test_size=test_size,
    random_state=seed)`` with a float ``test_size``: (train, test)."""
    n = len(rows)
    n_test = math.ceil(test_size * n)
    if n_test <= 0 or n_test >= n:
        raise ValueError(f"test_size={test_size} leaves an empty split of {n} rows")
    perm = np.random.RandomState(seed).permutation(n)
    return [rows[i] for i in perm[n_test:]], [rows[i] for i in perm[:n_test]]


def read_captions_csv(path) -> List[Row]:
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        required = ["video_id", "caption", "feature_path"]
        missing = [c for c in required if c not in (reader.fieldnames or [])]
        if missing:
            raise ValueError(f"Missing required columns: {missing}")
        return list(reader)


def prepare_data(config: Config) -> Tuple[List[Row], List[Row], List[Row]]:
    """Read the captions CSV, drop rows with missing features, and split
    train / val / test as the JAX package does (seed 42, twice)."""
    rows = [r for r in read_captions_csv(config.data.captions_file)
            if os.path.exists(r["feature_path"])]
    logger.info(f"Found {len(rows)} samples with valid feature files")
    holdout = config.data.val_split + config.data.test_split
    train, temp = shuffle_split(rows, holdout, seed=42)
    val_frac = config.data.val_split / holdout
    val, test = shuffle_split(temp, 1 - val_frac, seed=42)
    logger.info(f"Data splits - Train: {len(train)}, Val: {len(val)}, Test: {len(test)}")
    return train, val, test
