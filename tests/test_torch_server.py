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
def test_serve_cli_refuses_flags_not_ported(extra, tmp_path):
    from video_captioning_tpu_torch.cli import serve

    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--model-path", str(tmp_path / "m.pth"), *extra])
    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--model-path", str(tmp_path / "m.vcx")])
