"""Offline-capable METEOR scorer.

The upstream scorer reports METEOR through ``nltk.translate.meteor_score``
(src/utils/metrics.py:147-162 of the upstream project), which needs the wordnet
corpus downloaded at import (metrics.py:10-11) — in zero-egress
environments the metric silently disappears. This module implements the
same algorithm (Lavie & Agarwal 2007, as realized by NLTK: 3-stage
alignment exact → Porter-stem → wordnet-synonym, harmonic fmean with
alpha=0.9, fragmentation penalty gamma*(chunks/matches)^beta with
gamma=0.5, beta=3) with the wordnet stage active only when the corpus is
actually loadable, so METEOR is always reported:

* wordnet present  → numerically identical to NLTK/reference METEOR,
* wordnet absent   → exact+stem alignment only (the wordnet stage matches
  nothing), identical to NLTK with an empty synonym inventory.

Matching discipline mirrors NLTK exactly (tested): hypothesis words are
scanned in reverse, each matching the highest still-unused reference
position; stage leftovers flow into the next stage; matches are sorted by
hypothesis position before chunk counting.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional, Sequence, Tuple

try:
    from nltk.stem.porter import PorterStemmer  # corpus-free

    _STEMMER = PorterStemmer()
except Exception:  # pragma: no cover - nltk is a baked dependency
    _STEMMER = None

_WORDNET = None
_WORDNET_CHECKED = False


def _get_wordnet():
    """The nltk wordnet corpus reader, or None when the corpus is absent."""
    global _WORDNET, _WORDNET_CHECKED
    if _WORDNET_CHECKED:
        return _WORDNET
    _WORDNET_CHECKED = True
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("dog")  # force the lazy corpus load
        _WORDNET = wordnet
    except Exception:
        _WORDNET = None
    return _WORDNET


Enum = List[Tuple[int, str]]
Matches = List[Tuple[int, int]]


def _match_enums(hyp: Enum, ref: Enum) -> Tuple[Matches, Enum, Enum]:
    """Exact-surface matching: reverse scan over the hypothesis, each word
    taking the highest still-unused reference position of the same form."""
    ref_positions = defaultdict(list)
    for j, (_, word) in enumerate(ref):
        ref_positions[word].append(j)

    matches: Matches = []
    used_hyp, used_ref = set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        positions = ref_positions.get(hyp[i][1])
        if positions:
            j = positions.pop()
            used_hyp.add(i)
            used_ref.add(j)
            matches.append((hyp[i][0], ref[j][0]))

    hyp_left = [p for i, p in enumerate(hyp) if i not in used_hyp]
    ref_left = [p for j, p in enumerate(ref) if j not in used_ref]
    return matches, hyp_left, ref_left


def _stem_match(hyp: Enum, ref: Enum) -> Tuple[Matches, Enum, Enum]:
    if _STEMMER is None:
        return [], hyp, ref
    stemmed_hyp = [(i, _STEMMER.stem(w)) for i, w in hyp]
    stemmed_ref = [(j, _STEMMER.stem(w)) for j, w in ref]
    matches, hyp_left_s, ref_left_s = _match_enums(stemmed_hyp, stemmed_ref)
    # Map leftovers back to their unstemmed forms for the next stage.
    hyp_by_id = dict(hyp)
    ref_by_id = dict(ref)
    hyp_left = [(i, hyp_by_id[i]) for i, _ in hyp_left_s]
    ref_left = [(j, ref_by_id[j]) for j, _ in ref_left_s]
    return matches, hyp_left, ref_left


def _wordnet_match(hyp: Enum, ref: Enum, wordnet) -> Tuple[Matches, Enum, Enum]:
    if wordnet is None:
        return [], hyp, ref
    ref_positions = defaultdict(list)
    for j, (_, word) in enumerate(ref):
        ref_positions[word].append(j)

    matches: Matches = []
    used_hyp, used_ref = set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        word = hyp[i][1]
        syns = {
            lemma.name()
            for synset in wordnet.synsets(word)
            for lemma in synset.lemmas()
            if "_" not in lemma.name()
        }
        syns.add(word)
        best_j, best_word = -1, None
        for syn in syns:
            positions = ref_positions.get(syn)
            if positions and positions[-1] > best_j:
                best_j, best_word = positions[-1], syn
        if best_word is not None:
            ref_positions[best_word].pop()
            used_hyp.add(i)
            used_ref.add(best_j)
            matches.append((hyp[i][0], ref[best_j][0]))

    hyp_left = [p for i, p in enumerate(hyp) if i not in used_hyp]
    ref_left = [p for j, p in enumerate(ref) if j not in used_ref]
    return matches, hyp_left, ref_left


def _align(hyp: Enum, ref: Enum, wordnet) -> Matches:
    exact, hyp, ref = _match_enums(hyp, ref)
    stem, hyp, ref = _stem_match(hyp, ref)
    wns, hyp, ref = _wordnet_match(hyp, ref, wordnet)
    return sorted(exact + stem + wns, key=lambda pair: pair[0])


def _count_chunks(matches: Matches) -> int:
    chunks = 1
    for a, b in zip(matches, matches[1:]):
        if not (b[0] == a[0] + 1 and b[1] == a[1] + 1):
            chunks += 1
    return chunks


def single_meteor_score(
    reference: Sequence[str],
    hypothesis: Sequence[str],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    wordnet=None,
) -> float:
    """Sentence-level METEOR for one pre-tokenized (reference, hypothesis)."""
    if wordnet is None:
        wordnet = _get_wordnet()
    hyp = list(enumerate(w.lower() for w in hypothesis))
    ref = list(enumerate(w.lower() for w in reference))
    matches = _align(hyp, ref, wordnet)
    m = len(matches)
    if m == 0 or not hyp or not ref:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
    frag = _count_chunks(matches) / m
    return (1.0 - gamma * frag**beta) * fmean


def meteor_score(
    references: Iterable[Sequence[str]],
    hypothesis: Sequence[str],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    wordnet=None,
) -> float:
    """Multi-reference METEOR: best single score (NLTK call shape)."""
    return max(
        single_meteor_score(ref, hypothesis, alpha, beta, gamma, wordnet)
        for ref in references
    )


def wordnet_available() -> bool:
    return _get_wordnet() is not None
