"""The port's remaining inference paths on the CPU against the JAX package,
on one inference package that both load: ``predict_from_video`` in the
``pixel_stub`` and ``cnn`` (VGG16) feature modes on videos written with
OpenCV, ``generate_multiple_captions`` (beam and greedy),
``explain_prediction`` for both families, ``BatchPredictor`` and
``cli.predict single|batch|multiple``. Tokens must be identical; features
within 1e-4 relative, scores within 1e-4, attention weights and encoder
outputs within 2e-5."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import video_captioning_tpu.models.backbones as j_backbones
from video_captioning_tpu.cli import predict as j_cli
from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.inference.predictor import BatchPredictor as JaxBatchPredictor
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import init_model
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.cli import predict as t_cli
from video_captioning_tpu_torch.inference.predictor import BatchPredictor, VideoCaptionPredictor
from video_captioning_tpu_torch.models.weights import init_backbone_params_numpy

CAPTIONS = ["a man rides a horse", "a dog runs fast", "a cat sleeps on a mat"]


def _config(feature_dim=24, architecture="lstm"):
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = feature_dim, 16, 16
    m.embedding_dim, m.attention_dim = 12, 16
    m.max_sequence_length, m.video_sequence_length = 8, 10
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.data.img_size = [64, 64]
    if architecture == "transformer":
        m.architecture = "transformer"
        m.embedding_dim = m.decoder_hidden_dim
        m.transformer_num_heads = 4
    cfg.validate()
    return cfg


def _package(directory, cfg, seed=5):
    """A JAX-written package, the vocabulary projection sharpened x3 so
    beams separate (trained-model logit margins)."""
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_model(jax.random.PRNGKey(seed), cfg, len(vocab)))
    params["decoder"]["output_projection"]["kernel"] = \
        params["decoder"]["output_projection"]["kernel"] * 3.0
    return CheckpointManager(Path(directory)).save_model_for_inference(params, vocab, cfg)


@pytest.fixture(scope="module")
def lstm_pkg(tmp_path_factory):
    return _package(tmp_path_factory.mktemp("lstm"), _config())


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("videos")
    rs = np.random.RandomState(0)
    paths = []
    for name, n in (("clip_a.mp4", 12), ("clip_b.mp4", 7), ("clip_c.mp4", 15)):
        writer = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for _ in range(n):
            writer.write(rs.randint(0, 255, (48, 64, 3), np.uint8))
        writer.release()
        paths.append(root / name)
    return paths


def _features(seed, cfg, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(cfg.model.video_sequence_length, cfg.model.cnn_feature_dim)
            .astype(np.float32) for _ in range(n)]


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_predict_from_video_pixel_stub_matches_jax(lstm_pkg, videos, method):
    jp, tp = JaxPredictor(lstm_pkg), VideoCaptionPredictor(lstm_pkg, device="cpu")
    for path in videos:
        _close(tp._extract_video_features(path), jp._extract_video_features(path))
        want = jp.predict_from_video(path, method=method, beam_size=3, max_length=8)
        got = tp.predict_from_video(path, method=method, beam_size=3, max_length=8)
        assert got["tokens"] == list(want["tokens"]) and got["caption"] == want["caption"]
        assert got["video_path"] == want["video_path"] == str(path)


def test_predict_from_video_reads_the_npy_beside_it(lstm_pkg, tmp_path):
    tp = VideoCaptionPredictor(lstm_pkg, device="cpu")
    feats = _features(3, _config(), n=1)[0]
    np.save(tmp_path / "clip.npy", feats)
    got = tp.predict_from_video(tmp_path / "clip.mp4", extract_features=False)
    assert got["tokens"] == tp.predict_from_features(feats)["tokens"]
    with pytest.raises(FileNotFoundError):
        tp.predict_from_video(tmp_path / "other.mp4", extract_features=False)


def test_predict_from_video_cnn_vgg16_matches_jax(videos, tmp_path, monkeypatch):
    """--feature-mode cnn on a 4096-d model: VGG16 with random init allowed,
    the same numpy-seeded weights on both sides (the JAX initializer is
    patched to them in this test), 64 x 64 frames; then the CNN features'
    captions."""
    params = init_backbone_params_numpy("vgg16", seed=0)
    monkeypatch.setattr(j_backbones, "init_vgg16", lambda key: params)
    pkg = _package(tmp_path, _config(feature_dim=4096))
    jp = JaxPredictor(pkg, feature_mode="cnn", allow_random_cnn_init=True)
    tp = VideoCaptionPredictor(pkg, device="cpu", feature_mode="cnn", allow_random_cnn_init=True)
    path = videos[0]
    want, got = jp._extract_video_features(path), tp._extract_video_features(path)
    assert got.shape == (10, 4096) and tp._backbone.model_type == "vgg16"
    _close(got, want)
    for method in ("greedy", "beam"):
        assert (tp.predict_from_video(path, method=method, beam_size=3)["tokens"]
                == list(jp.predict_from_video(path, method=method, beam_size=3)["tokens"]))
    backbone = tp._backbone
    tp._extract_video_features(path)
    assert tp._backbone is backbone  # built once and kept


def test_predictor_refuses_an_unknown_feature_mode(lstm_pkg):
    with pytest.raises(ValueError, match="feature_mode"):
        VideoCaptionPredictor(lstm_pkg, device="cpu", feature_mode="pixels")


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_generate_multiple_captions_matches_jax(lstm_pkg, method):
    jp, tp = JaxPredictor(lstm_pkg), VideoCaptionPredictor(lstm_pkg, device="cpu")
    for feats in _features(1, _config(), n=2):
        want = jp.generate_multiple_captions(feats, num_captions=4, method=method, beam_size=3,
                                             max_length=8)
        got = tp.generate_multiple_captions(feats, num_captions=4, method=method, beam_size=3,
                                            max_length=8)
        assert len(got) == len(want) == 4
        assert [c["tokens"] for c in got] == [list(c["tokens"]) for c in want]
        assert [c["caption"] for c in got] == [c["caption"] for c in want]
        np.testing.assert_allclose([c["score"] for c in got], [c["score"] for c in want],
                                   rtol=1e-4, atol=1e-4)
        if method == "greedy":
            assert [c["temperature"] for c in got] == [c["temperature"] for c in want]


@pytest.mark.parametrize("architecture", ["lstm", "transformer"])
def test_explain_prediction_matches_jax(tmp_path, architecture):
    pkg = _package(tmp_path, _config(architecture=architecture))
    jp, tp = JaxPredictor(pkg), VideoCaptionPredictor(pkg, device="cpu")
    feats = _features(2, _config(), n=1)[0][:7]  # resized to 10 frames by both
    tokens = [1, 5, 6, 7, 2]
    want, got = jp.explain_prediction(feats, tokens), tp.explain_prediction(feats, tokens)
    assert got["attention_weights"].shape == (1, 4, 10)
    for key in ("attention_weights", "encoder_outputs"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=2e-5)
    assert (got["video_length"], got["caption_length"]) == (want["video_length"],
                                                           want["caption_length"]) == (10, 5)


def test_batch_predictor_keeps_order_and_isolates_errors(lstm_pkg, videos, tmp_path):
    """batch_size 2 puts the missing video inside the first chunk: the good
    one beside it is still served from the device batch; the results equal
    the JAX BatchPredictor's and one-at-a-time prediction."""
    missing = tmp_path / "nope.mp4"
    order = [videos[0], missing, videos[1], videos[2]]
    tp = VideoCaptionPredictor(lstm_pkg, device="cpu")
    got = BatchPredictor(tp, batch_size=2).predict_videos(order, method="beam", max_length=8,
                                                          beam_size=3)
    want = JaxBatchPredictor(JaxPredictor(lstm_pkg), batch_size=2).predict_videos(
        order, method="beam", max_length=8, beam_size=3)
    assert [r["video_path"] for r in got] == [str(p) for p in order]
    assert "error" in got[1] and got[1]["caption"] == ""
    assert list(got[1]) == list(want[1]) == ["video_path", "caption", "error"]
    for i, path in ((0, videos[0]), (2, videos[1]), (3, videos[2])):
        assert "error" not in got[i]
        assert got[i]["tokens"] == list(want[i]["tokens"])
        solo = tp.predict_from_video(path, method="beam", max_length=8, beam_size=3)
        assert got[i]["caption"] == solo["caption"]
    failing = BatchPredictor(tp, batch_size=4).predict_videos([tmp_path / "a.mp4",
                                                               tmp_path / "b.mp4"])
    assert len(failing) == 2 and all("error" in r for r in failing)


def _run_clis(argv_tail, tmp_path, pkg):
    """The same command through the JAX CLI and the port's (``--device
    cpu``); returns both --output JSON files, parsed."""
    out = {}
    for name, cli, extra in (("jax", j_cli, []), ("port", t_cli, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        cli.main(["--model-path", str(pkg), "--log-level", "WARNING", *extra, *argv_tail,
                  "--output", str(path)])
        out[name] = json.loads(path.read_text())
    return out["jax"], out["port"]


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_cli_predict_single_matches_jax(lstm_pkg, videos, tmp_path, method):
    feats = tmp_path / "f.npy"
    np.save(feats, _features(4, _config(), n=1)[0])
    for source in (["--features-path", str(feats)], []):
        want, got = _run_clis(["--method", method, "--beam-size", "3", "single",
                               "--video-path", str(videos[0]), *source], tmp_path, lstm_pkg)
        assert got == want


def test_cli_predict_batch_matches_jax(lstm_pkg, videos, tmp_path):
    feat_dir = tmp_path / "features"
    feat_dir.mkdir()
    for i, f in enumerate(_features(5, _config(), n=5)):
        np.save(feat_dir / f"v{i}.npy", f)
    listing = tmp_path / "videos.txt"
    listing.write_text("\n".join(str(p) for p in [videos[0], tmp_path / "gone.mp4", *videos[1:]]))
    for source in (["--features-dir", str(feat_dir)], ["--video-list", str(listing)]):
        want, got = _run_clis(["--method", "beam", "--beam-size", "3", "batch", *source,
                               "--batch-size", "2"], tmp_path, lstm_pkg)
        assert got == want
    assert "error" in got["results"][1]


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_cli_predict_multiple_matches_jax(lstm_pkg, videos, tmp_path, method):
    feats = tmp_path / "f.npy"
    np.save(feats, _features(6, _config(), n=1)[0])
    want, got = _run_clis(["--method", method, "--beam-size", "4", "multiple", "--video-path",
                           str(videos[1]), "--features-path", str(feats), "--num-captions", "3"],
                          tmp_path, lstm_pkg)
    for a, b in zip(got["captions"], want["captions"]):
        assert a["tokens"] == b["tokens"] and a["caption"] == b["caption"]
        assert abs(a["score"] - b["score"]) <= 1e-4 * max(1.0, abs(b["score"]))
    strip = [{k: v for k, v in c.items() if k != "score"} for c in got["captions"]]
    assert strip == [{k: v for k, v in c.items() if k != "score"} for c in want["captions"]]
    assert got["parameters"] == want["parameters"] and got["video_path"] == want["video_path"]


def test_cli_predict_defaults_to_the_card_and_refuses_sampling(lstm_pkg):
    args = t_cli.build_parser().parse_args(["--model-path", "m.pth", "single",
                                            "--video-path", "v.mp4"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VideoCaptionPredictor(lstm_pkg)
        # Sampling is ported: it reaches the predictor, on the card by default.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.main(["--model-path", str(lstm_pkg), "--method", "sample", "single",
                        "--video-path", "v.mp4"])
