"""The port's native batch feature loader (``native/vcload.cc``, built
with ``g++`` at first use into ``_build/``) on the CPU: its batches equal
the port's Python path (``resample_features``) byte for byte and the JAX
package's ``native.load_features_batch`` on the same files, for clips
shorter than, equal to and longer than the target length; an unsupported
layout returns None and the Python path is taken; and ``DataLoader``
batches are equal with and without the native path.

The JAX package builds its library in place (``native/libvcload.so``, by
``g++ -o`` with no lock), so a worker that loads it while another worker's
``g++`` is still writing it gets "file too short" and that process keeps
the Python path for good. The comparison therefore loads the JAX package's
loader from a private build of its own ``vcload.cc``, made by its own
``_build`` into this worker's temporary directory."""

import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest

import video_captioning_tpu.native as jax_native
from video_captioning_tpu_torch import native
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data import pipeline
from video_captioning_tpu_torch.data.vocabulary import Vocabulary

TARGET, FEAT = 80, 24
CAPTIONS = ["a man rides a horse", "a dog runs", "a cat sleeps on a bed", "the bird sings"]


def _files(tmp_path, lengths, seed=0):
    rs = np.random.RandomState(seed)
    paths = []
    for i, T in enumerate(lengths):
        path = tmp_path / f"c{i}.npy"
        np.save(path, rs.randn(T, FEAT).astype(np.float32))
        paths.append(str(path))
    return paths


def test_library_builds_into_the_build_directory():
    assert native.native_available()
    so = native.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent == Path(native.__file__).resolve().parent.parent
    assert not list(Path(native.__file__).resolve().parent.glob("*.so"))


@pytest.fixture(scope="module")
def jax_load_features_batch(tmp_path_factory):
    """The JAX package's ``load_features_batch`` on a library that its own
    ``_build`` compiled from its ``vcload.cc`` into a directory no other
    process writes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", tmp_path_factory.mktemp("jax_native") / "libvcload.so")
        mp.setattr(jax_native, "_lib_handle", None)
        mp.setattr(jax_native, "_build_failed", False)
        assert jax_native.native_available()
        yield jax_native.load_features_batch


@pytest.mark.parametrize("lengths", [(5, 17, 79), (80, 80), (81, 200, 1000), (3, 80, 313)])
def test_batches_equal_the_python_path_and_the_jax_loader(tmp_path, lengths,
                                                          jax_load_features_batch):
    paths = _files(tmp_path, lengths)
    got = native.load_features_batch(paths, TARGET, FEAT)
    assert got is not None and got.dtype == np.float32 and got.shape == (len(paths), TARGET, FEAT)
    want = np.stack([pipeline.resample_features(np.load(p).astype(np.float32), TARGET)
                     for p in paths])
    assert got.tobytes() == want.tobytes()
    jax_got = jax_load_features_batch(paths, TARGET, FEAT)
    assert jax_got is not None and got.tobytes() == jax_got.tobytes()


@pytest.mark.parametrize("bad", ["float64", "fortran", "wrong_dim", "three_d", "missing"])
def test_unsupported_layout_returns_none(tmp_path, bad):
    paths = _files(tmp_path, (10, 90))
    arr = np.random.RandomState(1).randn(12, FEAT)
    path = tmp_path / "bad.npy"
    if bad == "float64":
        np.save(path, arr)
    elif bad == "fortran":
        np.save(path, np.asfortranarray(arr.astype(np.float32)))
    elif bad == "wrong_dim":
        np.save(path, arr[:, :7].astype(np.float32))
    elif bad == "three_d":
        np.save(path, arr.astype(np.float32).reshape(2, 6, FEAT))
    assert native.load_features_batch(paths + [str(path)], TARGET, FEAT) is None


def _dataset(tmp_path, float64_at=None):
    cfg = PortConfig()
    cfg.model.cnn_feature_dim = FEAT
    cfg.model.max_sequence_length = 8
    cfg.data.frames_per_video = TARGET
    cfg.data.vocab_threshold = 1
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    rs = np.random.RandomState(3)
    rows = []
    for i in range(10):
        path = tmp_path / f"v{i}.npy"
        feats = rs.randn(int(rs.randint(20, 140)), FEAT)
        np.save(path, feats if i == float64_at else feats.astype(np.float32))
        rows.append({"video_id": f"v{i}", "video_path": "", "feature_path": str(path),
                     "caption": CAPTIONS[i % 4]})
    return pipeline.VideoCaptioningDataset(rows, vocab, cfg)


def _batches(dataset):
    loader = pipeline.DataLoader(dataset, 4, shuffle=True, drop_last=False, num_workers=2,
                                 seed=7)
    return list(loader)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), k
            else:
                assert x[k] == y[k], k


def test_data_loader_batches_equal_with_and_without_the_native_path(tmp_path):
    ds = _dataset(tmp_path)
    with_native = _batches(ds)
    assert ds.native_batches == len(with_native) == 3
    with mock.patch.object(pipeline, "load_features_batch", return_value=None):
        without = _batches(ds)
    assert ds.native_batches == 3
    _assert_same(with_native, without)


def test_a_file_the_loader_does_not_take_sends_its_batch_to_python(tmp_path):
    ds = _dataset(tmp_path, float64_at=2)
    batches = _batches(ds)
    assert ds.native_batches == 2  # the batch holding the float64 file went to Python
    with mock.patch.object(pipeline, "load_features_batch", return_value=None):
        _assert_same(batches, _batches(ds))


def test_a_failed_build_warns_once_and_takes_the_python_path(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "GXX_FLAGS", ("--no-such-flag",))
    paths = _files(tmp_path, (10,))
    assert native.load_features_batch(paths, TARGET, FEAT) is None
    assert native.load_features_batch(paths, TARGET, FEAT) is None
    assert not native.native_available()
    warnings = [r for r in caplog.records if "native loader build failed" in r.getMessage()]
    assert len(warnings) == 1
