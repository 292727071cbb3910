"""The port's preprocess CLI on the CPU against the JAX package's: the
per-clip .npy features of a tiny synthetic video (written with OpenCV),
the dataset CSV byte for byte (the port writes it with the csv module, the
JAX package with pandas), and the --overwrite skip."""

import os

import numpy as np
import pytest

from video_captioning_tpu.cli import convert_weights as jax_cw
from video_captioning_tpu.cli import preprocess as jax_preprocess
from video_captioning_tpu_torch.cli import preprocess as port_preprocess
from video_captioning_tpu_torch.data import video as port_video
from video_captioning_tpu_torch.models.weights import init_backbone_params_numpy

cv2 = pytest.importorskip("cv2")


def _write_video(path, n_frames, seed):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rs = np.random.RandomState(seed)
    for _ in range(n_frames):
        writer.write(rs.randint(0, 255, (48, 64, 3), np.uint8))
    writer.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    video_dir = root / "videos"
    video_dir.mkdir()
    _write_video(video_dir / "toy.mp4", 24, seed=0)
    _write_video(video_dir / "clip(1).mp4", 3, seed=1)  # shorter than 4: padded with the last
    weights = root / "resnet50.vcw.npz"
    jax_cw._save_checksummed_npz(weights, jax_cw.NATIVE_FORMAT, "resnet50",
                                 init_backbone_params_numpy("resnet50", seed=4))
    return root, video_dir, weights


def _argv(video_dir, out_dir, weights, *extra):
    return ["--video-dir", str(video_dir), "--output-dir", str(out_dir),
            "--model-type", "resnet50", "--weights", str(weights),
            "--backbone-variant", "folded", "--frames-per-video", "4", "--batch-size", "3",
            "--img-size", "64", "64", "--device", "cpu", *extra]


def test_preprocess_cli_matches_jax(videos):
    root, video_dir, weights = videos
    out_dir = root / "features"
    caps = root / "caps.txt"
    caps.write_text("first caption\nsecond caption\n")
    port_preprocess.main(_argv(video_dir, out_dir, weights, "--create-dataset",
                               "--captions-file", str(caps),
                               "--dataset-output", str(root / "port.csv")))
    jax_fx = jax_preprocess.VideoFeatureExtractor(
        "resnet50", batch_size=4, frames_per_video=4, img_size=(64, 64), weights_path=weights,
        variant="folded")
    for stem in ("toy", "clip(1)"):
        got = np.load(out_dir / f"{stem}.npy")
        assert got.shape == (4, 2048) and got.dtype == np.float32
        want = jax_fx.extract_video_features(video_dir / f"{stem}.mp4")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        port_video.extract_frames(video_dir / "clip(1).mp4", 4, resize=(64, 64))[2:],
        np.repeat(port_video.extract_frames(video_dir / "clip(1).mp4", 3, resize=(64, 64))[2:],
                  2, axis=0))
    jax_preprocess.create_dataset_csv(video_dir, out_dir, caps, root / "jax.csv")
    assert (root / "port.csv").read_bytes() == (root / "jax.csv").read_bytes()


@pytest.mark.parametrize("captions", ["csv", "none", "no_features"])
def test_dataset_csv_is_pandas_identical(videos, tmp_path, captions):
    root, video_dir, _ = videos
    feats = tmp_path / "feats"
    feats.mkdir()
    if captions != "no_features":
        for stem in ("toy", "clip(1)", "orphan"):  # orphan: no video, skipped
            np.save(feats / f"{stem}.npy", np.zeros((1, 2), np.float32))
    caps = None
    if captions == "csv":
        caps = tmp_path / "caps.csv"
        # "toy" matches exactly (before its substring match "toy_long"),
        # "clip(1)" only as a literal substring; commas and quotes round-trip.
        caps.write_text('video_id,caption\ntoy_long,"wrong, one"\ntoy,"a ""toy"", video"\n'
                        "x_clip(1)_y,a clip\n")
    port_preprocess.create_dataset_csv(video_dir, feats, caps, tmp_path / "port.csv")
    jax_preprocess.create_dataset_csv(video_dir, feats, caps, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_overwrite_flag(videos):
    root, video_dir, weights = videos
    out_dir = root / "features_ow"
    port_preprocess.main(_argv(video_dir, out_dir, weights))
    npy = out_dir / "toy.npy"
    os.utime(npy, ns=(10**9, 10**9))
    port_preprocess.main(_argv(video_dir, out_dir, weights))  # existing features are kept
    assert os.stat(npy).st_mtime_ns == 10**9
    port_preprocess.main(_argv(video_dir, out_dir, weights, "--overwrite"))
    assert os.stat(npy).st_mtime_ns != 10**9
    with pytest.raises(ValueError, match="does not exist"):
        port_preprocess.main(_argv(root / "missing", out_dir, weights))
