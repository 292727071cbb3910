"""The port's evaluation against the JAX package on the CPU: the diversity,
file and multi-reference metrics (equal within 1e-9 on every metric both
packages compute here) and ``cli.evaluate`` in file and dataset modes
(the same JSON)."""

import json
from pathlib import Path

import numpy as np
import pytest

import jax

from video_captioning_tpu.cli import evaluate as j_cli
from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.models import init_model
from video_captioning_tpu.utils import metrics as j_metrics
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.cli import evaluate as t_cli
from video_captioning_tpu_torch.utils import metrics as t_metrics

PREDICTIONS = ["a man is riding a horse", "a dog runs in the park", "a man is riding a horse",
               "a cat", "", "the woman is slicing an onion quickly"]
REFERENCES = [["a man rides a horse", "a person is riding a brown horse"],
              ["a dog is running in a park", "the dog runs"],
              ["someone rides a horse"],
              ["a cat is sleeping", "a kitten naps"],
              ["a bird flies"],
              ["a woman slices an onion", "someone is cutting an onion", "a woman cooks"]]


def _assert_same_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-9), k


def test_diversity_metrics_match_jax():
    want = j_metrics.CaptionMetrics().compute_diversity_metrics(PREDICTIONS)
    got = t_metrics.CaptionMetrics().compute_diversity_metrics(PREDICTIONS)
    assert want["self_bleu"] > 0
    _assert_same_metrics(got, want)
    assert t_metrics.CaptionMetrics().compute_diversity_metrics([]) == {}
    one = t_metrics.CaptionMetrics().compute_diversity_metrics(["a b"])
    _assert_same_metrics(one, j_metrics.CaptionMetrics().compute_diversity_metrics(["a b"]))


def test_multi_reference_metrics_match_jax():
    want = j_metrics.compute_metrics_multi_reference(PREDICTIONS, REFERENCES)
    got = t_metrics.compute_metrics_multi_reference(PREDICTIONS, REFERENCES)
    assert {"bleu_4", "cider"} <= set(got)
    _assert_same_metrics(got, want)
    assert t_metrics.compute_metrics_multi_reference([], []) == {}


def test_evaluate_model_outputs_matches_jax(tmp_path):
    (tmp_path / "p.txt").write_text("\n".join(PREDICTIONS) + "\n")
    (tmp_path / "r.txt").write_text("\n".join(r[0] for r in REFERENCES) + "\n")
    args = (str(tmp_path / "p.txt"), str(tmp_path / "r.txt"))
    _assert_same_metrics(t_metrics.evaluate_model_outputs(*args),
                         j_metrics.evaluate_model_outputs(*args))


def test_cli_evaluate_file_mode_matches_jax(tmp_path, capsys):
    (tmp_path / "p.txt").write_text("\n".join(PREDICTIONS) + "\n")
    (tmp_path / "r.txt").write_text("\n".join(r[0] for r in REFERENCES) + "\n")
    out = {}
    for name, cli in (("jax", j_cli), ("port", t_cli)):
        cli.main(["--predictions", str(tmp_path / "p.txt"), "--references",
                  str(tmp_path / "r.txt"), "--output", str(tmp_path / f"{name}.json")])
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    _assert_same_metrics(out["port"], out["jax"])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A JAX-written package (vocabulary projection sharpened x3) and a CSV
    of 16 seeded clips with 1-3 captions each, rows interleaved so first-seen
    order differs from sorted order, and one row whose feature file is
    missing."""
    tmp = tmp_path_factory.mktemp("evaluate")
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 16, 16
    m.embedding_dim, m.attention_dim = 12, 16
    m.max_sequence_length, m.video_sequence_length = 8, 10
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    words = ["a", "man", "dog", "cat", "runs", "rides", "horse", "sleeps", "park", "the"]
    rs = np.random.RandomState(0)
    rows = []
    for i in range(16):
        np.save(tmp / f"clip{i}.npy", rs.randn(10, 24).astype(np.float32))
        for _ in range(1 + i % 3):
            rows.append((f"clip{i}", " ".join(rs.choice(words, rs.randint(3, 7)))))
    order = rs.permutation(len(rows))
    lines = ["video_id,video_path,feature_path,caption"]
    lines += [f"{rows[j][0]},,{tmp / (rows[j][0] + '.npy')},{rows[j][1]}" for j in order]
    lines.append(f"gone,,{tmp / 'gone.npy'},a missing clip")
    (tmp / "captions.csv").write_text("\n".join(lines) + "\n")
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary([r[1] for r in rows])
    params = jax.tree_util.tree_map(np.asarray,
                                    init_model(jax.random.PRNGKey(2), cfg, len(vocab)))
    out_proj = params["decoder"]["output_projection"]
    out_proj["kernel"] = out_proj["kernel"] * 3.0
    pkg = CheckpointManager(tmp).save_model_for_inference(params, vocab, cfg)
    return pkg, tmp / "captions.csv"


@pytest.mark.parametrize("split,method", [("all", "beam"), ("test", "greedy"), ("train", "beam")])
def test_cli_evaluate_dataset_mode_matches_jax(dataset, tmp_path, split, method):
    """The same JSON: per-video predictions in first-seen order in chunks of
    5 (a ragged last chunk), single- and multi-reference scores; the row
    with a missing feature file dropped."""
    pkg, csv_path = dataset
    out = {}
    for name, cli, extra in (("jax", j_cli, []), ("port", t_cli, ["--device", "cpu"])):
        cli.main(["--model-path", str(pkg), "--data-file", str(csv_path), "--split", split,
                  "--method", method, "--beam-size", "3", "--max-length", "8",
                  "--batch-size", "5", "--log-level", "WARNING",
                  "--output", str(tmp_path / f"{name}.json"), *extra])
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    want, got = out["jax"], out["port"]
    for key in ("num_videos", "method", "samples"):
        assert got[key] == want[key], key
    for key in ("single_reference", "multi_reference"):
        _assert_same_metrics(got[key], want[key])
    if split == "all":
        assert got["num_videos"] == 16


def test_cli_evaluate_defaults_to_the_card():
    assert t_cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        t_cli.main([])
