"""Word-level vocabulary with exact token-id parity with the reference.

The port's copy of video_captioning_tpu/data/vocabulary.py: the same
token ids and JSON schema, and a CSV reader without pandas.

Parity contract (reference: src/data/vocabulary.py:12-311):

* special indices are fixed: PAD=0, START=1, END=2, UNK=3 (ref :35-38),
* tokenizer lowercases, strips non-word/non-space chars with the identical
  regex, and whitespace-splits (ref :93-112),
* vocabulary is frequency-thresholded (>= threshold), sorted most-frequent
  first (Python's stable sort ⇒ insertion order breaks ties, matching the
  reference's ``Counter`` iteration), and capped at ``max_vocab_size`` with
  4 slots reserved for specials (ref :56-91),
* encode adds START/END and falls back to UNK (ref :137-159),
* decode skips PAD/START, stops at END (ref :161-194),
* JSON save/load uses the same {word2idx, idx2word, config} schema (ref
  :196-243) so vocabulary.json files are interchangeable between frameworks.

Token IDs must match exactly for caption parity — this module is host-side
pure Python by design.
"""

from __future__ import annotations

import csv
import json
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set

from ..config import Config

_NON_WORD_RE = re.compile(r"[^\w\s]")


def tokenize(text: str) -> List[str]:
    """Lowercase, strip punctuation, whitespace-split (ref vocabulary.py:93-112)."""
    cleaned = _NON_WORD_RE.sub("", text.lower())
    return [t for t in cleaned.split() if t.strip()]


class Vocabulary:
    """Word ↔ index mapping with frozen special tokens."""

    def __init__(self, config: Config):
        self.config = config

        self.pad_token = config.data.pad_token
        self.start_token = config.data.start_token
        self.end_token = config.data.end_token
        self.unk_token = config.data.unk_token

        self.pad_idx = 0
        self.start_idx = 1
        self.end_idx = 2
        self.unk_idx = 3

        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        for idx, tok in enumerate(
            (self.pad_token, self.start_token, self.end_token, self.unk_token)
        ):
            self.word2idx[tok] = idx
            self.idx2word[idx] = tok

    # ------------------------------------------------------------- build

    def build_vocabulary(self, captions: Iterable[str]) -> None:
        captions = list(captions)
        counts: Counter = Counter()
        for caption in captions:
            counts.update(tokenize(caption))

        threshold = self.config.data.vocab_threshold
        kept = [w for w, c in counts.items() if c >= threshold]
        # Stable sort by descending frequency: ties keep Counter insertion
        # order — identical ordering to the reference (vocabulary.py:73-79).
        kept.sort(key=lambda w: counts[w], reverse=True)

        budget = self.config.data.max_vocab_size - 4
        if len(kept) > budget:
            kept = kept[:budget]

        for word in kept:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word

    def coverage(self, captions: Iterable[str]) -> float:
        """Fraction of caption tokens covered (ref vocabulary.py:114-135)."""
        total = 0
        covered = 0
        for caption in captions:
            for tok in tokenize(caption):
                total += 1
                if tok in self.word2idx:
                    covered += 1
        return covered / total if total else 0.0

    # ----------------------------------------------------- encode/decode

    def encode_caption(self, caption: str) -> List[int]:
        ids = [self.start_idx]
        for tok in tokenize(caption):
            ids.append(self.word2idx.get(tok, self.unk_idx))
        ids.append(self.end_idx)
        return ids

    def decode_caption(
        self, token_indices: Sequence[int], remove_special_tokens: bool = True
    ) -> str:
        specials = {self.pad_token, self.start_token, self.end_token}
        words: List[str] = []
        for idx in token_indices:
            idx = int(idx)
            if idx not in self.idx2word:
                continue
            word = self.idx2word[idx]
            if remove_special_tokens and word in specials:
                # Quirk replicated from the reference (vocabulary.py:182-192):
                # specials are skipped *before* the END break, so with
                # remove_special_tokens=True the loop never stops at END and
                # non-special tokens generated *after* END are kept. Load-
                # bearing for token-for-token caption parity.
                continue
            if word == self.end_token:
                break
            words.append(word)
        return " ".join(words)

    # ------------------------------------------------------------ persist

    def save(self, filepath: Path) -> None:
        payload = {
            "word2idx": self.word2idx,
            "idx2word": self.idx2word,
            "config": {
                "pad_token": self.pad_token,
                "start_token": self.start_token,
                "end_token": self.end_token,
                "unk_token": self.unk_token,
                "vocab_threshold": self.config.data.vocab_threshold,
                "max_vocab_size": self.config.data.max_vocab_size,
            },
        }
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, ensure_ascii=False)

    @classmethod
    def load(cls, filepath: Path, config: Config) -> "Vocabulary":
        with open(filepath, "r", encoding="utf-8") as f:
            payload = json.load(f)
        vocab = cls(config)
        vocab.word2idx = dict(payload["word2idx"])
        vocab.idx2word = {int(k): v for k, v in payload["idx2word"].items()}
        return vocab

    # ------------------------------------------------------------- dunder

    def __len__(self) -> int:
        return len(self.word2idx)

    def __contains__(self, word: str) -> bool:
        return word in self.word2idx

    # ---------------------------------------------------------- analysis

    def get_word_frequencies(self, captions: Iterable[str]) -> Dict[str, int]:
        counts: Counter = Counter()
        for caption in captions:
            counts.update(tokenize(caption))
        return dict(counts)

    def get_rare_words(self, captions: Iterable[str], threshold: int = 5) -> Set[str]:
        freqs = self.get_word_frequencies(captions)
        return {w for w, c in freqs.items() if c < threshold}


def build_vocabulary_from_csv(
    csv_path: Path, config: Config, caption_column: str = "caption"
) -> Vocabulary:
    """Build a vocabulary from a dataset CSV (ref vocabulary.py:285-311).

    Read with the ``csv`` module: an empty caption cell is skipped, as
    pandas' ``dropna`` skips it in the JAX package."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        captions = [row[caption_column] for row in csv.DictReader(f)
                    if row.get(caption_column)]
    vocab = Vocabulary(config)
    vocab.build_vocabulary(captions)
    return vocab
