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
  ``RandomState(seed + epoch)`` shuffle and drop-last, loading items on
  worker threads with a bounded prefetch queue. Features load one ``.npy``
  at a time (the JAX package's native batch loader is not ported).
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

from ..config import Config
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
        self.rows = [r for r in rows if os.path.exists(r["feature_path"])]
        if len(self.rows) != len(rows):
            logger.warning(f"{len(rows) - len(self.rows)} feature files not found; dropping rows")

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        row = self.rows[idx]
        features = np.load(row["feature_path"]).astype(np.float32)
        features = resample_features(features, self.config.data.frames_per_video)
        token_ids = self.vocabulary.encode_caption(row["caption"])
        max_len = self.config.model.max_sequence_length
        pad = self.vocabulary.pad_idx
        input_tokens = np.asarray(pad_tokens(token_ids[:-1], max_len, pad), np.int32)
        target_tokens = np.asarray(pad_tokens(token_ids[1:], max_len, pad), np.int32)
        return {
            "video_features": features,
            "input_tokens": input_tokens,
            "target_tokens": target_tokens,
            "caption_mask": (input_tokens != pad).astype(np.float32),
            "video_id": row.get("video_id", f"video_{idx}"),
            "caption_text": row["caption"],
        }


def _collate(items: List[Dict[str, object]]) -> Dict[str, object]:
    batch: Dict[str, object] = {}
    for key in ("video_features", "input_tokens", "target_tokens", "caption_mask"):
        batch[key] = np.stack([it[key] for it in items])
    batch["video_id"] = [it["video_id"] for it in items]
    batch["caption_text"] = [it["caption_text"] for it in items]
    return batch


class DataLoader:
    """Batched iterator with worker-thread loading and a bounded prefetch."""

    def __init__(self, dataset: VideoCaptioningDataset, batch_size: int, *,
                 shuffle: bool = False, drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 42):
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
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
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
                        if stop.is_set() or not put(
                                _collate(list(pool.map(self.dataset.__getitem__, batch_idx)))):
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


def create_data_loaders(
    config: Config,
    vocabulary: Vocabulary,
    train_rows: Sequence[Row],
    val_rows: Sequence[Row],
    test_rows: Optional[Sequence[Row]] = None,
) -> Tuple[DataLoader, DataLoader, Optional[DataLoader]]:
    """Train shuffles and drops the ragged tail; val and test do not."""
    common = dict(num_workers=config.training.num_workers,
                  prefetch=config.training.prefetch_batches, seed=config.training.seed)
    bs = config.training.batch_size

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
