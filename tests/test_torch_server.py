"""The port's caption server over a package written by the JAX package:
HTTP results equal the JAX predictor's on the same package, batching
works, and bad requests get the JAX server's HTTP codes."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.inference import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import init_model
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_server")
    cfg = Config()
    cfg.model.cnn_feature_dim = 24
    cfg.model.encoder_hidden_dim = 16
    cfg.model.decoder_hidden_dim = 16
    cfg.model.embedding_dim = 12
    cfg.model.attention_dim = 16
    cfg.model.video_sequence_length = 10
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast",
                            "two cats sleep on a red sofa"])
    params = init_model(jax.random.PRNGKey(5), cfg, len(vocab))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * 3.0  # trained-model logit margins
    pkg = CheckpointManager(tmp).save_model_for_inference(params, vocab, cfg)

    predictor = VideoCaptionPredictor(pkg, device="cpu")
    server = CaptionServer(predictor, port=0, max_batch=8, max_wait_ms=30.0)
    server.start()
    yield server, JaxPredictor(pkg)
    server.close()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _status(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_caption_equals_the_jax_predictor(served, method):
    server, jax_pred = served
    feats = np.random.RandomState(0).randn(7, 24).astype(np.float32)
    via_http = _post(server.port, "/caption", {"features": feats.tolist(), "method": method,
                                               "beam_size": 3, "max_length": 6})
    direct = jax_pred.predict_from_features(feats, method=method, beam_size=3, max_length=6)
    assert via_http["tokens"] == np.asarray(direct["tokens"]).tolist()
    assert via_http["caption"] == direct["caption"]
    assert via_http["method"] == method


def test_caption_batch_equals_the_jax_predictor(served):
    server, jax_pred = served
    rs = np.random.RandomState(1)
    clips = [rs.randn(n, 24).astype(np.float32) for n in (10, 4, 13)]  # pad, crop
    got = _post(server.port, "/caption_batch",
                {"items": [{"features": c.tolist()} for c in clips], "method": "beam",
                 "beam_size": 4, "max_length": 7})["results"]
    want = jax_pred.predict_batch(clips, method="beam", beam_size=4, max_length=7)
    assert [r["tokens"] for r in got] == [np.asarray(w["tokens"]).tolist() for w in want]
    assert [r["caption"] for r in got] == [w["caption"] for w in want]


def test_concurrent_requests_coalesce(served):
    server, _ = served
    rs = np.random.RandomState(2)
    feats = [rs.randn(10, 24).astype(np.float32) for _ in range(6)]
    before = server.metrics()["batches"]
    results = [None] * 6

    def call(i):
        results[i] = _post(server.port, "/caption", {"features": feats[i].tolist()})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    direct = server.batcher.predictor.predict_batch(feats)
    assert [r["tokens"] for r in results] == [d["tokens"] for d in direct]
    assert server.metrics()["batches"] - before < 6


def test_health_and_metrics(served):
    server, _ = served
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=10) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
        metrics = json.loads(r.read())
    assert {"requests", "batches", "latency_ms", "batch_occupancy_histogram"} <= set(metrics)
    url = f"http://127.0.0.1:{server.port}/metrics?format=prometheus"
    with urllib.request.urlopen(url, timeout=10) as r:
        assert "vct_requests_total" in r.read().decode()


@pytest.mark.parametrize("path,payload,code", [
    ("/caption", {"method": "greedy"}, 400),                          # no features
    ("/caption", {"features": [[0.0] * 5] * 3}, 400),                 # feature dim
    ("/caption", {"features": [[0.0] * 24, [0.0]]}, 400),             # ragged
    ("/caption", {"features": [], "method": "sample"}, 400),          # no frames
    ("/caption", {"features": [[0.0] * 24] * 3, "method": "bogus"}, 400),
    ("/caption_batch", {"items": []}, 400),
    ("/caption_batch", {"items": [{"features": [[0.0] * 24]}, {}]}, 400),
    ("/nowhere", {}, 404),
])
def test_bad_requests_get_http_errors(served, path, payload, code):
    server, _ = served
    assert _status(server.port, path, json.dumps(payload).encode()) == code


def test_bad_json_is_400(served):
    server, _ = served
    assert _status(server.port, "/caption", b"{not json") == 400


def test_batcher_counts_every_concurrent_submit():
    """Many HTTP threads submit at once: no request is lost or miscounted."""
    import sys

    from video_captioning_tpu_torch.inference.server import DynamicBatcher

    class Echo:
        def predict_batch(self, feats, **opts):
            return [{"tokens": [int(f[0, 0])], "caption": ""} for f in feats]

    batcher = DynamicBatcher(Echo(), max_batch=16, max_wait_ms=1.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n_threads, per_thread = 12, 40
        pending = [[] for _ in range(n_threads)]

        def submit(i):
            for j in range(per_thread):
                pending[i].append(batcher.submit(np.full((1, 1), i * 1000 + j, np.float32), {}))

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, items in enumerate(pending):
            for j, item in enumerate(items):
                assert item.done.wait(60)
                assert item.result["tokens"] == [i * 1000 + j]
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    assert batcher.stats["requests"] == n_threads * per_thread
    assert batcher.stats["batched_items"] == n_threads * per_thread


@pytest.mark.parametrize("extra", [
    ["--decode-int8", "full"], ["--decode-int8", "vocab"], ["--data-parallel"],
])
def test_serve_cli_refuses_flags_not_ported(extra, tmp_path, monkeypatch):
    """Every flag is ported. With a .vcx artifact --decode-int8 and
    --data-parallel are refused, as the JAX CLI refuses them;
    --data-parallel with a package serves one replica a device of an
    (n, 1) mesh, here the CPU."""
    from video_captioning_tpu_torch.cli import serve
    from video_captioning_tpu_torch.config import Config as PortConfig
    from video_captioning_tpu_torch.data.vocabulary import Vocabulary as PortVocabulary
    from video_captioning_tpu_torch.models.weights import init_params_numpy
    from video_captioning_tpu_torch.utils.checkpoint import save_model_for_inference

    match = "model-load time" if extra[0] == "--decode-int8" else "data-parallel"
    with pytest.raises(SystemExit, match=match):
        serve.main(["--model-path", str(tmp_path / "m.vcx"), *extra])
    if extra[0] != "--data-parallel":
        return
    cfg = PortConfig()
    cfg.model.cnn_feature_dim, cfg.model.encoder_hidden_dim = 24, 16
    cfg.model.decoder_hidden_dim, cfg.model.embedding_dim, cfg.model.attention_dim = 16, 12, 16
    cfg.data.vocab_threshold = 1
    vocab = PortVocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse"])
    pkg = save_model_for_inference(init_params_numpy(cfg, len(vocab)), vocab, cfg, tmp_path)
    served = {}
    monkeypatch.setattr(serve, "_serve", lambda predictor, args: served.update(p=predictor))
    serve.main(["--model-path", str(pkg), "--device", "cpu", *extra])
    assert served["p"].mesh.shape == {"data": 1, "model": 1}
    assert len(served["p"].replicas) == 1


def _tiny_port_package(tmp_path):
    from video_captioning_tpu_torch.config import Config as PortConfig
    from video_captioning_tpu_torch.data.vocabulary import Vocabulary as PortVocabulary
    from video_captioning_tpu_torch.models.weights import init_params_numpy
    from video_captioning_tpu_torch.utils.checkpoint import save_model_for_inference

    cfg = PortConfig()
    cfg.model.cnn_feature_dim, cfg.model.encoder_hidden_dim = 24, 16
    cfg.model.decoder_hidden_dim, cfg.model.embedding_dim, cfg.model.attention_dim = 16, 12, 16
    cfg.data.vocab_threshold = 1
    vocab = PortVocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse"])
    return save_model_for_inference(init_params_numpy(cfg, len(vocab)), vocab, cfg, tmp_path)


def _cards(monkeypatch, count):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


def test_serve_data_parallel_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """--data-parallel --device cuda on a host with no card raises, naming
    the device, instead of serving on the CPU."""
    from video_captioning_tpu_torch.cli import serve

    pkg = _tiny_port_package(tmp_path)
    _cards(monkeypatch, 0)
    served = {}
    monkeypatch.setattr(serve, "_serve", lambda predictor, args: served.update(p=predictor))
    with pytest.raises(RuntimeError, match="--device 'cuda': no CUDA device is visible"):
        serve.main(["--model-path", str(pkg), "--device", "cuda", "--data-parallel"])
    assert not served


def test_serve_data_parallel_on_cpu_ignores_visible_cards(tmp_path, monkeypatch):
    """--data-parallel --device cpu serves one replica on the CPU even where
    cards are visible: a (1, 1) mesh of the CPU."""
    import torch

    from video_captioning_tpu_torch.cli import serve

    pkg = _tiny_port_package(tmp_path)
    _cards(monkeypatch, 2)
    served = {}
    monkeypatch.setattr(serve, "_serve", lambda predictor, args: served.update(p=predictor))
    serve.main(["--model-path", str(pkg), "--device", "cpu", "--data-parallel"])
    p = served["p"]
    assert p.mesh.shape == {"data": 1, "model": 1}
    assert list(p.mesh.devices.reshape(-1)) == [torch.device("cpu")]
    assert p.device == torch.device("cpu") and len(p.replicas) == 1


@pytest.mark.parametrize("device,count,want", [
    ("cuda", 2, ["cuda:0", "cuda:1"]), ("cuda:1", 2, ["cuda:1"]), ("cpu", 2, ["cpu"]),
    ("cpu", 0, ["cpu"]), ("cuda", 0, "no CUDA device is visible"),
    ("cuda:1", 1, "CUDA device 1 is not visible"), ("mps", 1, "serves on cuda or cpu"),
])
def test_data_parallel_devices_follow_the_device_flag(device, count, want, monkeypatch):
    """The --data-parallel mesh's devices: every visible card for cuda, the
    named card for cuda:i, the CPU for cpu; a missing card raises."""
    import torch

    from video_captioning_tpu_torch.cli.serve import data_parallel_devices

    _cards(monkeypatch, count)
    if isinstance(want, list):
        assert data_parallel_devices(device) == [torch.device(d) for d in want]
    else:
        with pytest.raises((RuntimeError, ValueError), match=want):
            data_parallel_devices(device)
