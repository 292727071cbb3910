"""Ancestral sampling in the port against the JAX package on the CPU. The
port draws its Gumbel noise from a ``torch.Generator``; here it is handed
the noise JAX draws (``jax.random.gumbel`` of each step's split key, which
is what ``jax.random.categorical`` adds to the logits), so tokens and
log-probabilities must equal JAX's: ``sample_generate`` for top_k 0 and
k > 0 and both model families, ended rows, and the predictor, the server
and both CLIs with ``method="sample"``."""

import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.cli import evaluate as j_eval
from video_captioning_tpu.cli import predict as j_predict
from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.generation.sampling import sample_generate as j_sample
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.inference.server import CaptionServer as JaxServer
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch import generation as t_gen
from video_captioning_tpu_torch.cli import evaluate as t_eval
from video_captioning_tpu_torch.cli import predict as t_predict
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.generation import sampling as t_sampling
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params

VOCAB = 29
MAX_LEN = 8
CAPTIONS = ["a man rides a horse", "a dog runs in the park", "a cat sleeps on a bed"]


def port(cfg) -> PortConfig:
    return PortConfig.from_dict(cfg.to_dict())


def _config(architecture="lstm"):
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 16, 16
    m.embedding_dim, m.attention_dim, m.attention_num_heads = 12, 16, 4
    m.encoder_num_layers = 1
    m.max_sequence_length, m.video_sequence_length = MAX_LEN, 10
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    if architecture == "transformer":
        m.architecture = "transformer"
        m.embedding_dim = m.decoder_hidden_dim
        m.transformer_num_heads = 4
    elif architecture == "luong":
        m.attention_type = "luong"
    cfg.validate()
    return cfg


def _step_noise(key, steps, shape):
    """The Gumbel noise of ``sample_generate``'s steps for its ``rng``."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, shape, jnp.float32))))
    return out


class JaxPredictorNoise:
    """Stands in for ``sampling.gumbel_noise``: call c's step t gets the
    noise of the JAX predictor's c-th sampling call (its key split from
    PRNGKey(0) once per call) at step t. The port's loop draws at every one
    of its max_length steps."""

    def __init__(self, max_length):
        self.max_length, self.calls, self.key = max_length, 0, jax.random.PRNGKey(0)
        self.noise = []

    def __call__(self, shape, generator, device):
        t = self.calls % self.max_length
        if t == 0:
            self.key = jax.random.split(self.key)[0]
            self.noise = _step_noise(self.key, self.max_length, tuple(shape))
        self.calls += 1
        return self.noise[t]


def _pair(cfg, seed=0, end_bias=None):
    params = jax.tree_util.tree_map(np.array,
                                    init_model(jax.random.PRNGKey(seed), cfg, VOCAB))
    if end_bias is not None:
        params["decoder"]["output_projection"]["bias"][2] = end_bias
    model = VideoCaptioningModel(port(cfg), VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, port(cfg)))
    return params, model.eval()


def _sample_both(cfg, params, model, feats, mask, temperature, top_k, seed=3):
    key = jax.random.PRNGKey(seed)
    enc, final, jmask = j_cap.encode(params, cfg, jnp.asarray(feats), jnp.asarray(mask))
    want = jax.jit(lambda p, e, f, m: j_sample(p, cfg, e, f, 1, 2, MAX_LEN, m,
                                                temperature=temperature, top_k=top_k,
                                                rng=key))(params, enc, final, jmask)
    noise = _step_noise(key, MAX_LEN, (feats.shape[0], VOCAB))
    with torch.no_grad():
        got = t_gen.generate(model, port(cfg), torch.from_numpy(feats), 1, 2, MAX_LEN,
                             torch.from_numpy(mask), method="sample", temperature=temperature,
                             top_k=top_k, noise=noise)
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


def _inputs(B=6, seed=1):
    rs = np.random.RandomState(seed)
    feats = rs.randn(B, 10, 24).astype(np.float32)
    lengths = rs.randint(1, 11, size=B)
    lengths[0] = 10
    return feats, (np.arange(10)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("architecture", ["lstm", "luong", "transformer"])
@pytest.mark.parametrize("top_k,temperature", [(0, 1.0), (0, 0.7), (5, 0.7)])
def test_sample_matches_jax_with_its_noise(architecture, top_k, temperature):
    cfg = _config(architecture)
    params, model = _pair(cfg, seed=2)
    feats, mask = _inputs()
    want, got = _sample_both(cfg, params, model, feats, mask, temperature, top_k)
    np.testing.assert_array_equal(got["generated_tokens"], want["generated_tokens"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], rtol=1e-6, atol=1e-6)
    assert got["generated_tokens"].dtype == np.int32 and got["logprobs"].dtype == np.float32
    if top_k:  # every sampled token lies in its step's top k
        assert (want["generated_tokens"] < VOCAB).all()


@pytest.mark.parametrize("end_bias", [2.0, 30.0])
def test_ended_rows_give_pad_and_are_fed_end(monkeypatch, end_bias):
    """END favoured: rows end at different steps (2.0) or all at the first
    (30.0, the batch-wide stop). After its END a row emits PAD (0) and adds
    nothing to its log-probability, and END is what it is fed."""
    cfg = _config()
    params, model = _pair(cfg, seed=4, end_bias=end_bias)
    feats, mask = _inputs(seed=4)
    want, got = _sample_both(cfg, params, model, feats, mask, 1.0, 0, seed=5)
    np.testing.assert_array_equal(got["generated_tokens"], want["generated_tokens"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], rtol=1e-6, atol=1e-6)
    tokens = got["generated_tokens"]
    ends = [list(row).index(2) for row in tokens if 2 in row]
    assert ends, "no row ended"
    for row in tokens:
        if 2 in row:
            assert (row[list(row).index(2) + 1:] == 0).all()
    fed = []
    real_family = t_sampling.make_decode_family

    def spy_family(*a, **kw):
        fam = real_family(*a, **kw)

        def step(tokens, state, t):
            fed.append(tokens.clone())
            return fam.step(tokens, state, t)

        return fam._replace(step=step)

    monkeypatch.setattr(t_sampling, "make_decode_family", spy_family)
    key = jax.random.PRNGKey(5)
    with torch.no_grad():
        t_gen.generate(model, port(cfg), torch.from_numpy(feats), 1, 2, MAX_LEN,
                       torch.from_numpy(mask), method="sample",
                       noise=_step_noise(key, MAX_LEN, (feats.shape[0], VOCAB)))
    for b, row in enumerate(tokens):
        if 2 in row:
            e = list(row).index(2)
            assert all(int(fed[t][b]) == 2 for t in range(e + 1, MAX_LEN)), b


def test_default_noise_comes_from_the_generator():
    cfg = _config()
    _, model = _pair(cfg, seed=6)
    feats, mask = _inputs(seed=6)

    def run(seed):
        with torch.no_grad():
            return t_gen.generate(model, port(cfg), torch.from_numpy(feats), 1, 2, MAX_LEN,
                                  torch.from_numpy(mask), method="sample", temperature=1.5,
                                  generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a["generated_tokens"], b["generated_tokens"])
    assert torch.equal(a["logprobs"], b["logprobs"])
    assert not torch.equal(a["generated_tokens"], c["generated_tokens"])
    g = t_sampling.gumbel_noise((200_000,), torch.Generator().manual_seed(0), torch.device("cpu"))
    assert abs(float(g.mean()) - 0.5772) < 0.01 and torch.isfinite(g).all()


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sample")
    cfg = _config()
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(CAPTIONS)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_model(jax.random.PRNGKey(8), cfg, len(vocab)))
    return CheckpointManager(tmp).save_model_for_inference(params, vocab, cfg)


def _features(seed, n):
    rs = np.random.RandomState(seed)
    return [rs.randn(10, 24).astype(np.float32) for _ in range(n)]


def test_predictor_sample_paths_match_jax(package, monkeypatch):
    """predict_batch (3 clips, bucket 4), predict_from_features and
    generate_multiple_captions, in one predictor each: the port's calls
    take the JAX predictor's per-call keys in the same order."""
    monkeypatch.setattr(t_sampling, "gumbel_noise", JaxPredictorNoise(MAX_LEN))
    jp, tp = JaxPredictor(Path(package)), VideoCaptionPredictor(package, device="cpu")
    feats = _features(9, 3)
    want = jp.predict_batch(feats, method="sample", max_length=MAX_LEN, temperature=0.8)
    got = tp.predict_batch(feats, method="sample", max_length=MAX_LEN, temperature=0.8)
    assert [r["tokens"] for r in got] == [list(r["tokens"]) for r in want]
    assert [r["caption"] for r in got] == [r["caption"] for r in want]
    want = jp.predict_from_features(feats[0], method="sample", max_length=MAX_LEN)
    got = tp.predict_from_features(feats[0], method="sample", max_length=MAX_LEN)
    assert got["tokens"] == list(want["tokens"]) and got["method"] == "sample"
    assert got["logprob"] == pytest.approx(want["logprob"], rel=1e-6, abs=1e-6)
    want = jp.generate_multiple_captions(feats[1], num_captions=3, method="sample",
                                         max_length=MAX_LEN, temperature=1.2)
    got = tp.generate_multiple_captions(feats[1], num_captions=3, method="sample",
                                        max_length=MAX_LEN, temperature=1.2)
    assert [c["tokens"] for c in got] == [list(c["tokens"]) for c in want]
    assert [c["caption"] for c in got] == [c["caption"] for c in want]
    for a, b in zip(got, want):
        assert a["score"] == pytest.approx(b["score"], rel=1e-6, abs=1e-6)


def test_predictor_sample_top_k_and_seed(package):
    """``sample_top_k`` truncates; the generator lives on the predictor's
    device, seeded by ``sample_seed``, and advances with every call."""
    feats = _features(10, 4)
    a = VideoCaptionPredictor(package, device="cpu", sample_seed=3)
    b = VideoCaptionPredictor(package, device="cpu", sample_seed=3)
    first = [r["tokens"] for r in a.predict_batch(feats, method="sample", temperature=2.0)]
    assert first == [r["tokens"] for r in b.predict_batch(feats, method="sample",
                                                          temperature=2.0)]
    assert a._sample_generator.device == torch.device("cpu")
    second = [r["tokens"] for r in a.predict_batch(feats, method="sample", temperature=2.0)]
    assert second != first
    k1 = VideoCaptionPredictor(package, device="cpu", sample_top_k=1)
    greedy = [r["tokens"] for r in k1.predict_batch(feats, method="greedy")]
    assert [r["tokens"] for r in k1.predict_batch(feats, method="sample")] == greedy


def _post(port_, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port_}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_server_sample_matches_jax(package, monkeypatch):
    monkeypatch.setattr(t_sampling, "gumbel_noise", JaxPredictorNoise(MAX_LEN))
    feats = _features(11, 2)
    out = {}
    for name, server in (("jax", JaxServer(JaxPredictor(Path(package)), port=0)),
                         ("port", CaptionServer(VideoCaptionPredictor(package, device="cpu"),
                                                port=0))):
        server.start()
        try:
            out[name] = _post(server.port, "/caption",
                              {"features": feats[0].tolist(), "method": "sample",
                               "temperature": 0.7, "max_length": MAX_LEN})
            batch = _post(server.port, "/caption_batch",
                          {"items": [{"features": f.tolist()} for f in feats],
                           "method": "sample", "max_length": MAX_LEN})
            assert len(batch["results"]) == 2
            assert all(len(r["tokens"]) == MAX_LEN for r in batch["results"])
        finally:
            server.close()
    assert out["port"]["tokens"] == out["jax"]["tokens"]
    assert out["port"] == out["jax"]


def test_cli_predict_and_evaluate_sample_match_jax(package, tmp_path, monkeypatch):
    np.save(tmp_path / "f.npy", _features(12, 1)[0])
    out = {}
    for name, cli, extra in (("jax", j_predict, []), ("port", t_predict, ["--device", "cpu"])):
        monkeypatch.setattr(t_sampling, "gumbel_noise", JaxPredictorNoise(MAX_LEN))
        cli.main(["--model-path", str(package), "--method", "sample", "--temperature", "0.9",
                  "--max-length", str(MAX_LEN), "--log-level", "WARNING", *extra,
                  "single", "--video-path", "v.mp4", "--features-path", str(tmp_path / "f.npy"),
                  "--output", str(tmp_path / f"{name}.json")])
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    assert out["port"]["tokens"] == out["jax"]["tokens"]
    assert out["port"]["caption"] == out["jax"]["caption"]
    rows = ["video_id,video_path,feature_path,caption"]
    for i, f in enumerate(_features(13, 5)):
        np.save(tmp_path / f"c{i}.npy", f)
        rows.append(f"c{i},,{tmp_path / f'c{i}.npy'},{CAPTIONS[i % 3]}")
    (tmp_path / "d.csv").write_text("\n".join(rows) + "\n")
    for name, cli, extra in (("jax", j_eval, []), ("port", t_eval, ["--device", "cpu"])):
        monkeypatch.setattr(t_sampling, "gumbel_noise", JaxPredictorNoise(MAX_LEN))
        cli.main(["--model-path", str(package), "--data-file", str(tmp_path / "d.csv"),
                  "--split", "all", "--method", "sample", "--max-length", str(MAX_LEN),
                  "--batch-size", "3", "--log-level", "WARNING",
                  "--output", str(tmp_path / f"e_{name}.json"), *extra])
        out[name] = json.loads((tmp_path / f"e_{name}.json").read_text())
    assert out["port"]["samples"] == out["jax"]["samples"]
    assert out["port"]["method"] == "sample" and out["port"]["num_videos"] == 5
