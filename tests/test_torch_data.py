"""The port's data pipeline, vocabulary and caption metrics, which need no
pandas, scikit-learn or NLTK, against the JAX package's, which use them."""

import csv

import numpy as np
import pandas as pd
import pytest

from video_captioning_tpu.data import pipeline as j_pipeline
from video_captioning_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from video_captioning_tpu.data.vocabulary import build_vocabulary_from_csv as j_build_vocab
from video_captioning_tpu.utils.metrics import CaptionMetrics as JaxCaptionMetrics
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data import pipeline
from video_captioning_tpu_torch.data.vocabulary import Vocabulary, build_vocabulary_from_csv
from video_captioning_tpu_torch.utils import metrics
from video_captioning_tpu_torch.utils.tb_writer import RawEventWriter

WORDS = "a man woman dog cat is are running sleeping on the red big small ball".split()


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _sentences(n, seed, lo=0, hi=12):
    rs = np.random.RandomState(seed)
    return [" ".join(rs.choice(WORDS, rs.randint(lo, hi + 1))) for _ in range(n)]


def _dataset(tmp_path, n, seed=0, missing=()):
    """``n`` rows of (video_id, video_path, feature_path, caption) with
    features of varying length; the rows in ``missing`` have no file."""
    rs = np.random.RandomState(seed)
    captions = _sentences(n, seed, lo=1)
    rows = []
    for i in range(n):
        path = tmp_path / f"v{i}.npy"
        if i not in missing:
            np.save(path, rs.randn(rs.randint(5, 16), 24).astype(np.float32))
        rows.append({"video_id": f"v{i}", "video_path": "", "feature_path": str(path),
                     "caption": captions[i] + ("," if i % 3 == 0 else "")})
    csv_path = tmp_path / "captions.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows, csv_path


@pytest.mark.parametrize("n", [20, 37, 96])
def test_prepare_data_splits_equal_sklearn(tiny_config, tmp_path, n):
    """The seed-42 ShuffleSplit twice, rows with no feature file dropped
    first: the same ids in the same order as pandas + scikit-learn."""
    _, csv_path = _dataset(tmp_path, n, missing={3, n - 2})
    tiny_config.data.captions_file = csv_path
    want = j_pipeline.prepare_data(tiny_config)
    got = pipeline.prepare_data(port(tiny_config))
    for w, g in zip(want, got):
        assert [r["video_id"] for r in g] == list(w["video_id"])


def test_prepare_data_rejects_missing_columns(tiny_config, tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("video_id,caption\nv0,a man\n")
    cfg = port(tiny_config)
    cfg.data.captions_file = path
    with pytest.raises(ValueError, match="feature_path"):
        pipeline.prepare_data(cfg)


def test_vocabulary_from_csv_equals_jax(tiny_config, tmp_path):
    """Punctuation stripped, an empty caption skipped (pandas' dropna),
    frequency order with first-seen ties, thresholds and the size cap."""
    rows, csv_path = _dataset(tmp_path, 40)
    with open(csv_path, "a", newline="", encoding="utf-8") as f:
        f.write("v40,,,\n")  # empty caption
    for threshold, cap in ((1, 50), (2, 50), (1, 10)):
        tiny_config.data.vocab_threshold = threshold
        tiny_config.data.max_vocab_size = cap
        want = j_build_vocab(csv_path, tiny_config, "caption")
        got = build_vocabulary_from_csv(csv_path, port(tiny_config), "caption")
        assert got.word2idx == want.word2idx and got.idx2word == want.idx2word
    sample = rows[5]["caption"] + " unseenword"
    assert got.encode_caption(sample) == want.encode_caption(sample)
    ids = [1, 7, 2, 5, 0, 0]
    assert got.decode_caption(ids) == want.decode_caption(ids)


def test_vocabulary_json_round_trips_between_packages(tiny_config, tmp_path):
    tiny_config.data.vocab_threshold = 1
    vocab = Vocabulary(port(tiny_config))
    vocab.build_vocabulary(_sentences(30, 1))
    vocab.save(tmp_path / "vocabulary.json")
    back = JaxVocabulary.load(tmp_path / "vocabulary.json", tiny_config)
    assert back.word2idx == vocab.word2idx and back.idx2word == vocab.idx2word


def test_dataset_items_equal_jax(tiny_config, tmp_path):
    """Resampled or zero-padded features, shifted and PAD-padded tokens,
    the caption mask."""
    rows, _ = _dataset(tmp_path, 8)
    tiny_config.data.vocab_threshold = 1
    jv = JaxVocabulary(tiny_config)
    jv.build_vocabulary([r["caption"] for r in rows])
    pv = Vocabulary(port(tiny_config))
    pv.build_vocabulary([r["caption"] for r in rows])
    jd = j_pipeline.VideoCaptioningDataset(pd.DataFrame(rows), jv, tiny_config)
    pd_ = pipeline.VideoCaptioningDataset(rows, pv, port(tiny_config))
    assert len(jd) == len(pd_) == 8
    for i in range(8):
        want, got = jd[i], pd_[i]
        assert set(got) == set(want)
        for k in ("video_features", "input_tokens", "target_tokens", "caption_mask"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["video_id"] == want["video_id"]


@pytest.mark.parametrize("shuffle", [False, True])
def test_data_loader_batches_equal_jax(tiny_config, tmp_path, shuffle):
    """Per-epoch RandomState(seed + epoch) shuffle and drop-last: the same
    batches in the same order, epoch after epoch."""
    rows, _ = _dataset(tmp_path, 11, missing={4})
    tiny_config.data.vocab_threshold = 1
    jv = JaxVocabulary(tiny_config)
    jv.build_vocabulary([r["caption"] for r in rows])
    pv = Vocabulary(port(tiny_config))
    pv.build_vocabulary([r["caption"] for r in rows])
    jl = j_pipeline.DataLoader(j_pipeline.VideoCaptioningDataset(pd.DataFrame(rows), jv,
                                                                 tiny_config),
                               3, shuffle=shuffle, drop_last=shuffle, num_workers=2, seed=5)
    pl = pipeline.DataLoader(pipeline.VideoCaptioningDataset(rows, pv, port(tiny_config)),
                             3, shuffle=shuffle, drop_last=shuffle, num_workers=2, seed=5)
    assert len(pl) == len(jl) == (3 if shuffle else 4)
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want)
        for wb, gb in zip(want, got):
            assert gb["video_id"] == wb["video_id"]
            for k in ("video_features", "input_tokens", "target_tokens", "caption_mask"):
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_data_loader_stops_cleanly_when_abandoned(tiny_config, tmp_path):
    rows, _ = _dataset(tmp_path, 12)
    cfg = port(tiny_config)
    cfg.data.vocab_threshold = 1
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary([r["caption"] for r in rows])
    loader = pipeline.DataLoader(pipeline.VideoCaptioningDataset(rows, vocab, cfg), 2,
                                 prefetch=1)
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert sum(1 for _ in loader) == 6


def test_bleu_equals_nltk():
    """Sentence BLEU-1..4 with smoothing method4, term for term: empty,
    one-word and exact hypotheses included."""
    from nltk.translate.bleu_score import SmoothingFunction, sentence_bleu

    smooth = SmoothingFunction().method4
    hyps = _sentences(60, 2) + ["", "man", "a man is running", "dog dog dog dog dog"]
    refs = _sentences(60, 3, lo=1) + ["a man", "man", "a man is running", "a dog"]
    for hyp, ref in zip(hyps, refs):
        for n in range(1, 5):
            w = tuple([1.0 / n] * n + [0.0] * (4 - n))
            want = sentence_bleu([ref.split()], hyp.split(), weights=w, smoothing_function=smooth)
            got = metrics.sentence_bleu([ref.split()], hyp.split(), w)
            assert abs(got - want) <= 1e-9, (hyp, ref, n, got, want)


def test_caption_metrics_equal_jax():
    """Every score the JAX package's CaptionMetrics reports, BLEU-1..4 and
    CIDEr included, from the same predictions and references."""
    preds, refs = _sentences(25, 4), _sentences(25, 5, lo=1)
    preds[3], refs[3] = "a man is running", "a man is running"
    want = JaxCaptionMetrics().compute_metrics(preds, refs)
    got = metrics.CaptionMetrics().compute_metrics(preds, refs)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-9, (k, got[k], v)


def test_bleu_needs_no_nltk(monkeypatch):
    """BLEU-4, which picks the best model, is computed without NLTK."""
    monkeypatch.setattr(metrics, "METEOR_AVAILABLE", False)
    monkeypatch.setattr(metrics, "ROUGE_AVAILABLE", False)
    out = metrics.CaptionMetrics().compute_metrics(["a man is running"], ["a man is running"])
    assert out["bleu_4"] == pytest.approx(1.0) and "meteor" not in out


def test_raw_event_writer_writes_framed_scalars(tmp_path):
    w = RawEventWriter(str(tmp_path))
    w.add_scalar("Train/BatchLoss", 1.5, 3)
    w.close()
    data = w.path.read_bytes()
    n = int.from_bytes(data[:8], "little")
    second = data[8 + 4 + n + 4:]
    assert b"brain.Event:2" in data[:8 + 4 + n] and b"Train/BatchLoss" in second
    assert [p.name for p in tmp_path.iterdir()] == [w.path.name]
