"""Serving artifacts of the port (``inference/export.py``,
``cli/export.py``), mirroring tests/test_export.py: programs exported with
``torch.export`` on the CPU serve tokens equal to the port's live
predictor and to the JAX package's, for the LSTM and the transformer,
beam and greedy; ragged batches pad to their bucket and larger ones
chunk; a tampered program is refused by its sha256; a JAX-written
``.vcx`` is refused by its format (and the JAX loader refuses the
port's); the CLI round trip and serving over HTTP; full-pipeline
``include_cnn`` programs in float32 and int8; and ``opcheck`` of every
``vct::`` custom op (``ops/library.py``) with its fake implementation."""

import json
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import jax

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.inference import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.inference.export import ExportedPredictor as JaxExportedPredictor
from video_captioning_tpu.inference.export import export_serving_artifact as jax_export
from video_captioning_tpu.models import init_model
from video_captioning_tpu.utils.checkpoint import CheckpointManager
from video_captioning_tpu_torch.cli import export as export_cli
from video_captioning_tpu_torch.cli import serve as serve_cli
from video_captioning_tpu_torch.inference.export import (
    ARTIFACT_FORMAT,
    ExportedPredictor,
    export_serving_artifact,
)
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.ops import launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops import library


def _tiny_package(tmp, architecture="lstm", seed=7, sharpen=3.0):
    cfg = Config()
    m = cfg.model
    m.architecture = architecture
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 16, 16
    m.encoder_num_layers = m.decoder_num_layers = 2
    m.embedding_dim = 16 if architecture == "transformer" else 12
    m.attention_dim, m.attention_num_heads, m.transformer_num_heads = 16, 4, 4
    m.max_sequence_length, m.video_sequence_length = 8, 10
    cfg.data.frames_per_video = 10
    cfg.data.vocab_threshold = 1
    cfg.validate()
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast", "a cat sits still"])
    params = jax.tree_util.tree_map(np.array, init_model(jax.random.PRNGKey(seed), cfg,
                                                         len(vocab)))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * sharpen  # trained-model logit margins
    pkg = CheckpointManager(tmp).save_model_for_inference(params, vocab, cfg)
    return pkg, cfg


def _features(cfg, n, seed=3):
    rs = np.random.RandomState(seed)
    return rs.randn(n, cfg.model.video_sequence_length,
                    cfg.model.cnn_feature_dim).astype(np.float32)


@pytest.fixture(scope="module")
def exported_beam(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_export")
    pkg, cfg = _tiny_package(tmp)
    out = export_serving_artifact(pkg, tmp / "model.vcx", batch_sizes=[2, 4], method="beam",
                                  max_length=8, beam_size=3, platforms=["cpu"])
    return (out, pkg, cfg, VideoCaptionPredictor(pkg, device="cpu"),
            ExportedPredictor(out, device="cpu"))


def _tokens(results):
    return [r["tokens"] for r in results]


def test_beam_tokens_match_live_predictor_and_jax(exported_beam):
    _, pkg, cfg, live, aot = exported_beam
    feats = _features(cfg, 4)
    kw = dict(method="beam", max_length=8, beam_size=3)
    live_results = live.predict_batch(list(feats), **kw)
    aot_results = aot.predict_batch(feats)
    assert len(aot_results) == 4
    for lr, ar in zip(live_results, aot_results):
        assert ar["tokens"] == lr["tokens"]
        assert ar["caption"] == lr["caption"]
        assert ar["method"] == "beam" and np.isfinite(ar["score"])
    assert _tokens(aot_results) == _tokens(JaxPredictor(pkg).predict_batch(list(feats), **kw))
    assert aot.manifest["format"] == ARTIFACT_FORMAT


def test_program_holds_the_custom_ops_and_runs_their_plain_versions(exported_beam, tmp_path):
    """With ``kernels.interpret`` (the kernels' contracts on the CPU) the
    program keeps the encoder's ``vct::lstm_seq`` nodes and the beam
    step's ``vct::topk2d_lse``; on the CPU they run the plain versions, so
    nothing launches, and the tokens are the live predictor's."""
    from video_captioning_tpu_torch.config import Config as PortConfig

    _, pkg, cfg, _, _ = exported_beam
    pcfg = PortConfig.from_dict(cfg.to_dict())
    pcfg.kernels.interpret = True
    out = export_serving_artifact(pkg, tmp_path / "ops.vcx", batch_sizes=[2], method="beam",
                                  max_length=8, beam_size=3, platforms=["cpu"], config=pcfg)
    aot = ExportedPredictor(out, device="cpu")
    program = aot._load_program("programs", 2)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum("vct.lstm_seq" in t for t in targets) == cfg.model.encoder_num_layers
    assert sum("vct.topk2d_lse" in t for t in targets) == 8  # one a step
    reset_launch_counts()
    feats = _features(cfg, 2)
    live = VideoCaptionPredictor(pkg, config=pcfg, device="cpu")
    assert _tokens(aot.predict_batch(feats)) == _tokens(
        live.predict_batch(list(feats), method="beam", max_length=8, beam_size=3))
    assert sum(launch_counts().values()) == 0


def test_the_predictor_serves_a_vcx_through_its_exported_predictor(exported_beam):
    out, _, cfg, live, _ = exported_beam
    aot = VideoCaptionPredictor(out, device="cpu", compute_dtype="float32")
    assert isinstance(aot, ExportedPredictor)
    feats = _features(cfg, 2, seed=5)
    assert _tokens(aot.predict_batch(feats)) == _tokens(
        live.predict_batch(list(feats), method="beam", max_length=8, beam_size=3))
    with pytest.raises(ValueError, match="baked compute_dtype=float32"):
        VideoCaptionPredictor(out, device="cpu", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="model-load time"):
        VideoCaptionPredictor(out, device="cpu", decode_int8="vocab")


def test_ragged_batch_pads_to_bucket(exported_beam):
    _, _, cfg, live, aot = exported_beam
    feats = _features(cfg, 3, seed=11)  # 3 -> bucket 4
    assert _tokens(aot.predict_batch(feats)) == _tokens(
        live.predict_batch(list(feats), method="beam", max_length=8, beam_size=3))


def test_oversized_batch_chunks(exported_beam):
    _, _, cfg, live, aot = exported_beam
    feats = _features(cfg, 7, seed=13)  # > the largest bucket (4): 4 + 3
    aot_results = aot.predict_batch(feats)
    assert len(aot_results) == 7
    assert _tokens(aot_results) == _tokens(
        live.predict_batch(list(feats), method="beam", max_length=8, beam_size=3))


def test_single_clip_surface_and_bad_shapes(exported_beam):
    _, _, cfg, _, aot = exported_beam
    rec = aot.predict_from_features(_features(cfg, 1, seed=17)[0])
    assert isinstance(rec["caption"], str) and len(rec["tokens"]) == 9  # START + max_length
    with pytest.raises(ValueError, match="expected features shaped"):
        aot.predict_batch(np.zeros((2, 5, cfg.model.cnn_feature_dim)))
    with pytest.raises(ValueError, match=r"expected \(B, T, F\)"):
        aot.predict_batch(np.zeros((10, 24)))


def test_checksum_tamper_detected(exported_beam, tmp_path):
    out, _, cfg, _, _ = exported_beam
    tampered = tmp_path / "tampered.vcx"
    with zipfile.ZipFile(out) as src, zipfile.ZipFile(tampered, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "program_b2_cpu.pt2":
                data = data[:100] + bytes([data[100] ^ 0xFF]) + data[101:]
            dst.writestr(name, data)
    aot = ExportedPredictor(tampered, device="cpu")
    with pytest.raises(ValueError, match="checksum mismatch"):
        aot.predict_batch(_features(cfg, 2))


def test_wrong_format_and_platform_rejected(exported_beam, tmp_path):
    bogus = tmp_path / "bogus.vcx"
    with zipfile.ZipFile(bogus, "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format": "other-v9"}))
    with pytest.raises(ValueError, match="not a vcx-torch-v1 artifact"):
        ExportedPredictor(bogus, device="cpu")
    with pytest.raises(ValueError, match="vcx-torch-v1"):
        JaxExportedPredictor(exported_beam[0])  # the JAX loader refuses the port's format


def test_jax_written_artifact_refused_by_its_format(tmp_path):
    pkg, _ = _tiny_package(tmp_path)
    out = jax_export(pkg, tmp_path / "jax.vcx", batch_sizes=[1], method="greedy",
                     max_length=4, platforms=["cpu"])
    with pytest.raises(ValueError, match="'vcx-v1' artifact written by the JAX package"):
        ExportedPredictor(out, device="cpu")


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("architecture", ["lstm", "transformer"])
def test_exported_tokens_equal_live_and_jax(tmp_path, architecture, method):
    pkg, cfg = _tiny_package(tmp_path, architecture=architecture, seed=5)
    kw = dict(method=method, max_length=6)
    if method == "beam":
        kw["beam_size"] = 3
    out = export_serving_artifact(pkg, tmp_path / "m.vcx", batch_sizes=[4], platforms=["cpu"],
                                  **kw)
    aot = ExportedPredictor(out, device="cpu")
    feats = _features(cfg, 4, seed=23)
    got = _tokens(aot.predict_batch(feats))
    assert got == _tokens(VideoCaptionPredictor(pkg, device="cpu").predict_batch(list(feats),
                                                                                 **kw))
    assert got == _tokens(JaxPredictor(pkg).predict_batch(list(feats), **kw))
    assert all(r["method"] == method for r in aot.predict_batch(feats))
    assert aot.manifest["model_config"]["model"]["architecture"] == architecture


def test_list_input_resamples_like_live_predictor(exported_beam):
    _, _, cfg, live, aot = exported_beam
    rs = np.random.RandomState(31)
    clips = [rs.randn(n, cfg.model.cnn_feature_dim).astype(np.float32) for n in (7, 10, 15)]
    kw = dict(method="beam", max_length=8, beam_size=3)
    assert _tokens(aot.predict_batch(clips, **kw)) == _tokens(live.predict_batch(clips, **kw))
    with pytest.raises(ValueError, match="clip 0"):
        aot.predict_batch([rs.randn(7, 5).astype(np.float32)])


def test_validate_options_rejects_unbaked(exported_beam):
    aot = exported_beam[4]
    aot.validate_options({})
    aot.validate_options(dict(aot.generation_defaults))
    for options, match in (({"method": "greedy"}, "method"), ({"beam_size": 5}, "beam_size=3"),
                           ({"max_length": 12}, "max_length=8"),
                           ({"temperature": 0.7}, "temperature"),
                           ({"max_length": None}, "not a number"),
                           ({"beam_size": [3]}, "not a number"),
                           ({"temperature": "hot"}, "not a number")):
        with pytest.raises(ValueError, match=match):
            aot.validate_options(options)


def test_serve_artifact_over_http(exported_beam):
    """CaptionServer over an ExportedPredictor: option-less requests serve
    the baked program, conflicting options are 400 at parse time."""
    _, _, cfg, live, aot = exported_beam
    server = CaptionServer(aot, port=0, max_batch=8, max_wait_ms=5.0)
    server.start()
    try:
        feats = np.random.RandomState(37).randn(6, cfg.model.cnn_feature_dim).astype(np.float32)

        def post(path, payload):
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        direct = live.predict_batch([feats], method="beam", max_length=8, beam_size=3)[0]
        res = post("/caption", {"features": feats.tolist()})
        assert res["tokens"] == direct["tokens"] and res["caption"] == direct["caption"]
        assert res["method"] == "beam"
        res = post("/caption", {"features": feats.tolist(), "method": "beam", "beam_size": 3,
                                "max_length": 8})
        assert res["tokens"] == direct["tokens"]
        res = post("/caption_batch", {"items": [{"features": feats.tolist()}] * 2})
        assert [r["tokens"] for r in res["results"]] == [direct["tokens"]] * 2
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/caption", {"features": feats.tolist(), "beam_size": 5})
        assert err.value.code == 400
        assert "beam_size=3" in json.loads(err.value.read())["error"]
    finally:
        server.close()


def test_serve_cli_rejects_conflicting_vcx_flags(tmp_path, monkeypatch):
    """.vcx programs are single-device with a baked dtype: the serve CLI
    refuses what it cannot honour, and accepts a matching --compute-dtype."""
    with pytest.raises(SystemExit, match="data-parallel"):
        serve_cli.main(["--model-path", "m.vcx", "--data-parallel"])
    pkg, _ = _tiny_package(tmp_path)
    out = tmp_path / "serve.vcx"
    export_cli.main(["--model-path", str(pkg), "--output", str(out), "--batch-sizes", "1",
                     "--method", "greedy", "--max-length", "4", "--platforms", "cpu"])
    with pytest.raises(SystemExit, match="compute-dtype|baked"):
        serve_cli.main(["--model-path", str(out), "--device", "cpu",
                        "--compute-dtype", "bfloat16"])
    served = {}
    monkeypatch.setattr(serve_cli, "_serve", lambda predictor, args: served.update(p=predictor))
    serve_cli.main(["--model-path", str(out), "--device", "cpu", "--compute-dtype", "float32"])
    assert served["p"].manifest["compute_dtype"] == "float32"


def test_cli_roundtrip(tmp_path, capsys):
    pkg, cfg = _tiny_package(tmp_path)
    out = tmp_path / "cli.vcx"
    export_cli.main(["--model-path", str(pkg), "--output", str(out), "--batch-sizes", "2",
                     "--method", "beam", "--beam-size", "2", "--max-length", "6",
                     "--device", "cpu"])
    assert out.exists() and "wrote" in capsys.readouterr().out
    aot = ExportedPredictor(out, device="cpu")
    res = aot.predict_batch(_features(cfg, 2, seed=29))
    assert len(res) == 2 and all(len(r["tokens"]) == 7 for r in res)
    m = aot.manifest
    assert m["beam_size"] == 2 and m["platforms"] == ["cpu"]
    assert m["vocabulary"]["special_tokens"]["end_idx"] == 2
    cuda_only = tmp_path / "cuda_only.vcx"
    with zipfile.ZipFile(out) as src, zipfile.ZipFile(cuda_only, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "manifest.json":
                data = json.dumps(dict(json.loads(data), platforms=["cuda"]))
            dst.writestr(name, data)
    with pytest.raises(ValueError, match=r"holds programs for \['cuda'\], not cpu"):
        ExportedPredictor(cuda_only, device="cpu")


# ---------------------------------------------------- full pipeline


def _cnn_package(tmp, frames=3, img=32):
    """A tiny captioner with ResNet50's 2048-d features."""
    cfg = Config()
    m = cfg.model
    m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 2048, 16, 16
    m.embedding_dim, m.attention_dim = 12, 16
    m.max_sequence_length, m.video_sequence_length = 6, frames
    cfg.data.frames_per_video = frames
    cfg.data.img_size = (img, img)
    cfg.data.vocab_threshold = 1
    cfg.validate()
    vocab = Vocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast", "a cat sits still"])
    params = init_model(jax.random.PRNGKey(9), cfg, len(vocab))
    return CheckpointManager(tmp).save_model_for_inference(params, vocab, cfg), cfg


def _frames(cfg, n, seed=17):
    h, w = cfg.data.img_size
    return np.random.RandomState(seed).randint(
        0, 256, (n, cfg.model.video_sequence_length, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("variant", ["folded", "int8"])
def test_include_cnn_matches_the_live_cnn_path(tmp_path, variant):
    """frames -> CNN -> decode in one program equals the live
    FeatureExtractor feeding the features program (the same random-init
    ResNet50; int8 from a calibrated vcw-int8-v1 file)."""
    from video_captioning_tpu_torch.models.backbones import FeatureExtractor

    pkg, cfg = _cnn_package(tmp_path)
    from video_captioning_tpu_torch.config import Config as PortConfig

    pcfg = PortConfig.from_dict(cfg.to_dict())
    kw = dict(allow_random_cnn_init=True, cnn_variant=variant)
    if variant == "int8":
        fx = FeatureExtractor("resnet50", pcfg, allow_random_init=True, variant="int8",
                              device="cpu")
        fx.calibrate_int8(_frames(cfg, 2, seed=23).reshape(-1, *cfg.data.img_size, 3))
        int8_file = tmp_path / "resnet50_int8.npz"
        fx.save_int8(int8_file)
        kw = dict(cnn_weights_path=int8_file)
    out = export_serving_artifact(pkg, tmp_path / "full.vcx", batch_sizes=[2], method="beam",
                                  max_length=5, beam_size=2, platforms=["cpu"], include_cnn=True,
                                  frame_batch_sizes=[2], cnn_chunk=4, **kw)
    aot = ExportedPredictor(out, device="cpu")
    assert aot.includes_cnn and aot.manifest["cnn"]["variant"] == variant
    assert aot.frame_shape == [cfg.model.video_sequence_length, *cfg.data.img_size, 3]
    assert aot.batch_sizes == [2]
    frames = _frames(cfg, 2)
    from_frames = aot.predict_from_frames(frames)
    live = (FeatureExtractor("resnet50", pcfg, weights_path=kw["cnn_weights_path"],
                             device="cpu") if variant == "int8"
            else FeatureExtractor("resnet50", pcfg, allow_random_init=True, variant=variant,
                                  device="cpu"))
    B, T = frames.shape[:2]
    feats = live.extract(frames.reshape(B * T, *frames.shape[2:])).reshape(B, T, -1)
    assert _tokens(from_frames) == _tokens(aot.predict_batch(feats))
    assert aot.predict_from_frames(frames[:1])[0]["tokens"] == from_frames[0]["tokens"]
    assert _tokens(aot.predict_from_frames([frames[0], frames[1]])) == _tokens(from_frames)


def test_predict_from_frames_guards(exported_beam):
    aot = exported_beam[4]
    assert not aot.includes_cnn
    with pytest.raises(ValueError, match="include_cnn"):
        aot.predict_from_frames(np.zeros((1, 4, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="include_cnn"):
        _ = aot.frame_shape


# ------------------------------------------------------------ custom ops


def _op_samples():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    T, ND, B, H = 3, 2, 2, 8
    N, D, S, K = 6, 16, 5, 3
    mask = torch.ones(2, 5)
    mask[1, 3:] = 0
    anc = torch.zeros(N // K, K, 4, dtype=torch.int32)
    w_pad = r(16, 32, dtype=torch.bfloat16)
    w2 = r(8, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    return {
        "lstm_seq": (r(T, ND, B, 4 * H), r(ND, H, 4 * H, dtype=torch.bfloat16),
                     torch.ones(B, T)),
        "topk2d_lse": (r(4, 30), 5),
        "topk2d": (r(4, 30), 5),
        "lstm_cell": (r(4, 12), r(4, H), r(4, H), r(4 * H, 12), r(4 * H, H), r(4 * H),
                      r(4 * H), -1),
        "bahdanau_attend": (r(2, 16), r(8, 16), r(8), r(2, 5, 8), r(2, 5, 6), r(8), r(1), mask),
        "vocab_topk_lse": (r(4, 16), w_pad, r(32), 5),
        "beam_self_attention": (r(N, D), r(4, N, D), r(4, N, D), anc, 2, 4, K),
        "beam_cross_attention": (r(N, D), r(2, S, D), r(2, S, D), mask, 4, K),
        "fused_bottleneck": (r(1, 4, 4, 16), r(8, 16), r(8), w2, r(8), r(16, 8), r(16)),
        "matmul_bias_act": (r(5, 6), r(7, 6), r(7), r(5, 7), True),
        "int8_matmul_requant": (i8(5, 20), i8(7, 20), r(7).abs(), r(7), 0.05, True),
        "int8_matmul_residual_requant": (i8(5, 20), i8(7, 20), r(7).abs(), r(7), i8(5, 7), 0.1,
                                         None),
    }


@pytest.mark.parametrize("name", list(_op_samples()))
def test_custom_op_passes_opcheck(name):
    """Schema, fake (output shapes, dtypes and strides), autograd
    registration and dispatch of each ``vct::`` op on CPU samples; its CPU
    implementation is the plain version of the wrapper."""
    op = getattr(torch.ops.vct, name)
    args = _op_samples()[name]
    torch.library.opcheck(op, args)
    assert len(library.CUSTOM_OPS) == len(_op_samples())
