"""Caption quality metrics for validation.

Counterpart of video_captioning_tpu/utils/metrics.py (``CaptionMetrics``),
with the same numbers where its libraries are installed:

* BLEU-1..4: NLTK's ``sentence_bleu`` with ``SmoothingFunction().method4``
  (k = 5), reimplemented here in plain Python so that best-model selection
  by BLEU-4 does not depend on NLTK being installed;
* CIDEr: the upstream project's simplified TF-IDF cosine over 1..4-grams
  (document frequencies over predictions and references together);
* METEOR (the port's copy of ``utils/meteor.py``, which needs NLTK's
  Porter stemmer) and ROUGE (``rouge_score``) are reported only where
  their libraries import, as in the JAX package.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

try:
    from nltk.stem.porter import PorterStemmer  # noqa: F401  (METEOR's stemmer)

    from .meteor import meteor_score

    METEOR_AVAILABLE = True
except ImportError:
    METEOR_AVAILABLE = False

try:
    from rouge_score import rouge_scorer

    ROUGE_AVAILABLE = True
except ImportError:
    ROUGE_AVAILABLE = False

_SMOOTHING_K = 5  # NLTK SmoothingFunction's default k


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


def _modified_precision(refs: Sequence[Sequence[str]], hyp: Sequence[str],
                        n: int) -> Tuple[int, int]:
    counts = _ngram_counts(hyp, n)
    max_ref: Dict[tuple, int] = {}
    for ref in refs:
        ref_counts = _ngram_counts(ref, n)
        for gram in counts:
            max_ref[gram] = max(max_ref.get(gram, 0), ref_counts[gram])
    numerator = sum(min(c, max_ref[g]) for g, c in counts.items())
    return numerator, max(1, sum(counts.values()))


def sentence_bleu(refs: Sequence[Sequence[str]], hyp: Sequence[str],
                  weights: Sequence[float]) -> float:
    """NLTK's ``sentence_bleu(refs, hyp, weights, SmoothingFunction().method4)``,
    term for term."""
    p_n = [_modified_precision(refs, hyp, i) for i in range(1, len(weights) + 1)]
    hyp_len = len(hyp)
    ref_len = min((len(r) for r in refs), key=lambda r: (abs(r - hyp_len), r))
    if p_n[0][0] == 0:
        return 0.0
    # method4: a zero count becomes 1 / (2^k' * K / ln(len(hyp))) over its
    # denominator, k' counting the zero orders from 1.
    smoothed, incvnt = [], 1
    for num, den in p_n:
        if num == 0 and hyp_len > 1:
            smoothed.append((1 / (2 ** incvnt * _SMOOTHING_K / math.log(hyp_len))) / den)
            incvnt += 1
        else:
            smoothed.append(num / den)
    if hyp_len > ref_len:
        bp = 1.0
    elif hyp_len == 0:
        bp = 0.0
    else:
        bp = math.exp(1 - ref_len / hyp_len)
    s = (w * math.log(p) for w, p in zip(weights, smoothed) if p > 0)
    return bp * math.exp(math.fsum(s))


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(" ".join(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


class CaptionMetrics:
    """Corpus scorer over (prediction, reference) caption pairs."""

    def __init__(self, vocabulary=None):
        self.vocabulary = vocabulary
        if ROUGE_AVAILABLE:
            self._rouge = rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"],
                                                   use_stemmer=True)

    def compute_metrics(self, predictions: List[str], references: List[str]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        out.update(self._basic(predictions, references))
        out.update(self._bleu(predictions, references))
        if METEOR_AVAILABLE:
            try:
                out["meteor"] = self._meteor(predictions, references)
            except Exception:
                pass
        if ROUGE_AVAILABLE:
            out.update(self._rouge_scores(predictions, references))
        out["cider"] = self._cider(predictions, references)
        return out

    def _basic(self, predictions: List[str], references: List[str]) -> Dict[str, float]:
        pred_lens = [len(p.split()) for p in predictions]
        ref_lens = [len(r.split()) for r in references]
        pred_vocab, ref_vocab = set(), set()
        for p in predictions:
            pred_vocab.update(p.lower().split())
        for r in references:
            ref_vocab.update(r.lower().split())
        union = pred_vocab | ref_vocab
        return {
            "avg_pred_length": sum(pred_lens) / len(pred_lens) if pred_lens else 0,
            "avg_ref_length": sum(ref_lens) / len(ref_lens) if ref_lens else 0,
            "vocab_overlap": len(pred_vocab & ref_vocab) / len(union) if union else 0,
        }

    def _bleu(self, predictions: List[str], references: List[str]) -> Dict[str, float]:
        sums = {f"bleu_{n}": 0.0 for n in range(1, 5)}
        for pred, ref in zip(predictions, references):
            hyp, refs = pred.lower().split(), [ref.lower().split()]
            for n in range(1, 5):
                weights = tuple([1.0 / n] * n + [0.0] * (4 - n))
                sums[f"bleu_{n}"] += sentence_bleu(refs, hyp, weights)
        count = len(predictions)
        return {k: v / count for k, v in sums.items()} if count else sums

    def _meteor(self, predictions: List[str], references: List[str]) -> float:
        total = 0.0
        for pred, ref in zip(predictions, references):
            try:
                total += meteor_score([ref.lower().split()], pred.lower().split())
            except Exception:
                pass
        return total / len(predictions) if predictions else 0.0

    def _rouge_scores(self, predictions: List[str], references: List[str]) -> Dict[str, float]:
        sums = {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}
        for pred, ref in zip(predictions, references):
            scored = self._rouge.score(ref, pred)
            for k in sums:
                sums[k] += scored[k].fmeasure
        count = len(predictions)
        return {k: v / count for k, v in sums.items()} if count else sums

    def _cider(self, predictions: List[str], references: List[str]) -> float:
        """The upstream project's simplified CIDEr, as the JAX package has it."""
        all_texts = predictions + references
        doc_freq: Dict[str, int] = {}
        all_grams = set()
        for text in all_texts:
            toks = text.lower().split()
            for n in range(1, 5):
                for g in _ngrams(toks, n):
                    all_grams.add(g)
                    doc_freq[g] = doc_freq.get(g, 0) + 1

        def tf_idf(grams: Counter) -> Dict[str, float]:
            total = sum(grams.values())
            return {g: (c / total if total else 0.0) * math.log(len(all_texts) / doc_freq.get(g, 1))
                    for g, c in grams.items()}

        score_sum = 0.0
        for pred, ref in zip(predictions, references):
            p_toks, r_toks = pred.lower().split(), ref.lower().split()
            s = 0.0
            for n in range(1, 5):
                p_vec, r_vec = tf_idf(_ngrams(p_toks, n)), tf_idf(_ngrams(r_toks, n))
                dot = sum(p_vec.get(g, 0.0) * r_vec.get(g, 0.0) for g in all_grams)
                p_norm = math.sqrt(sum(v * v for v in p_vec.values()))
                r_norm = math.sqrt(sum(v * v for v in r_vec.values()))
                if p_norm > 0 and r_norm > 0:
                    s += dot / (p_norm * r_norm)
            score_sum += s / 4
        return score_sum / len(predictions) if predictions else 0.0
