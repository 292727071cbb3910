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
  their libraries import, as in the JAX package;
* ``compute_diversity_metrics`` (vocabulary size, type-token ratio,
  distinct-1..3, self-BLEU), ``evaluate_model_outputs`` (prediction and
  reference files) and ``compute_metrics_multi_reference`` (every
  reference of a clip at once: multi-reference BLEU and METEOR, the best
  ROUGE and CIDEr over the references), as the JAX package scores them.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Dict, List, Sequence, Tuple

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

    def compute_diversity_metrics(self, predictions: List[str]) -> Dict[str, float]:
        """Vocabulary size, type-token ratio, distinct-1..3 and self-BLEU
        (each prediction's BLEU-4 against every other one, averaged)."""
        if not predictions:
            return {}
        all_tokens: List[str] = []
        for p in predictions:
            all_tokens.extend(p.lower().split())
        vocab_size = len(set(all_tokens))
        total = len(all_tokens)
        out: Dict[str, float] = {"vocab_size": vocab_size,
                                 "ttr": vocab_size / total if total else 0.0}
        for n in range(1, 4):
            grams: List[str] = []
            for p in predictions:
                toks = p.lower().split()
                grams.extend(" ".join(toks[i: i + n]) for i in range(len(toks) - n + 1))
            out[f"distinct_{n}"] = len(set(grams)) / len(grams) if grams else 0.0
        self_bleu = 0.0
        if len(predictions) > 1:
            for i, pred in enumerate(predictions):
                hyp = pred.lower().split()
                others = predictions[:i] + predictions[i + 1:]
                self_bleu += sum(sentence_bleu([o.lower().split()], hyp, (0.25,) * 4)
                                 for o in others) / len(others)
            self_bleu /= len(predictions)
        out["self_bleu"] = self_bleu
        return out


def evaluate_model_outputs(predictions_file: str, references_file: str,
                           vocabulary=None) -> Dict[str, Any]:
    """Score a predictions text file against a references text file, one
    caption a line: ``compute_metrics`` and the diversity metrics."""
    with open(predictions_file, "r") as f:
        predictions = [line.strip() for line in f]
    with open(references_file, "r") as f:
        references = [line.strip() for line in f]
    scorer = CaptionMetrics(vocabulary)
    results = scorer.compute_metrics(predictions, references)
    results.update(scorer.compute_diversity_metrics(predictions))
    return results


def compute_metrics_multi_reference(predictions: List[str],
                                    reference_groups: List[List[str]]) -> Dict[str, float]:
    """Each prediction against all of its clip's references: sentence BLEU
    and METEOR in their multi-reference forms, the best ROUGE f-measure
    over the references, and the simplified CIDEr with document
    frequencies over the whole corpus (predictions and every reference),
    best cosine over the references."""
    scorer = CaptionMetrics()
    out: Dict[str, float] = {}
    n = len(predictions)
    if n == 0:
        return out
    sums = {f"bleu_{k}": 0.0 for k in range(1, 5)}
    meteor_sum, meteor_ok = 0.0, METEOR_AVAILABLE
    for pred, refs in zip(predictions, reference_groups):
        hyp = pred.lower().split()
        ref_tok = [r.lower().split() for r in refs]
        for k in range(1, 5):
            sums[f"bleu_{k}"] += sentence_bleu(ref_tok, hyp, tuple([1.0 / k] * k + [0.0] * (4 - k)))
        if meteor_ok:
            try:
                meteor_sum += meteor_score(ref_tok, hyp)
            except Exception:
                meteor_ok = False
    out.update({k: v / n for k, v in sums.items()})
    if meteor_ok:
        out["meteor"] = meteor_sum / n

    if ROUGE_AVAILABLE:
        sums = {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}
        for pred, refs in zip(predictions, reference_groups):
            best = {k: 0.0 for k in sums}
            for ref in refs:
                scored = scorer._rouge.score(ref, pred)
                for k in sums:
                    best[k] = max(best[k], scored[k].fmeasure)
            for k in sums:
                sums[k] += best[k]
        out.update({k: v / n for k, v in sums.items()})

    all_texts = list(predictions) + [r for refs in reference_groups for r in refs]
    doc_freq: Dict[str, int] = {}
    for text in all_texts:
        toks = text.lower().split()
        for k in range(1, 5):
            for g in _ngrams(toks, k):
                doc_freq[g] = doc_freq.get(g, 0) + 1
    n_docs = len(all_texts)

    def tf_idf(tokens, k):
        grams = _ngrams(tokens, k)
        total = sum(grams.values())
        return {g: (c / total) * math.log(n_docs / doc_freq.get(g, 1))
                for g, c in grams.items()} if total else {}

    def cosine(a, b):
        dot = sum(v * b.get(g, 0.0) for g, v in a.items())
        na = math.sqrt(sum(v * v for v in a.values()))
        nb = math.sqrt(sum(v * v for v in b.values()))
        return dot / (na * nb) if na > 0 and nb > 0 else 0.0

    cider_sum = 0.0
    for pred, refs in zip(predictions, reference_groups):
        p_toks = pred.lower().split()
        cider_sum += max([0.0] + [sum(cosine(tf_idf(p_toks, k), tf_idf(r.lower().split(), k))
                                      for k in range(1, 5)) / 4 for r in refs])
    out["cider"] = cider_sum / n
    return out
