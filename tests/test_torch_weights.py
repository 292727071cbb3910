"""The weight bridge and inference packages between the JAX package and the
PyTorch port, and the port's independence from JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from video_captioning_tpu.config import Config
from video_captioning_tpu.data.vocabulary import Vocabulary
from video_captioning_tpu.models import init_model
from video_captioning_tpu.models.torch_port import import_reference_state_dict
from video_captioning_tpu.utils.checkpoint import CheckpointManager, restore_params
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.data.vocabulary import Vocabulary as PortVocabulary
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import (
    init_params_numpy,
    state_dict_from_jax_params,
)
from video_captioning_tpu_torch.utils import checkpoint as port_ckpt

REPO = Path(__file__).resolve().parent.parent


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("encoder_hidden", [16, 20])
def test_bridge_round_trip_is_exact(tiny_config, encoder_hidden):
    cfg = tiny_config
    cfg.model.encoder_hidden_dim = encoder_hidden  # 20 != 16: init_state_projection
    params = init_model(jax.random.PRNGKey(3), cfg, 37)
    sd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), port(cfg))
    model = VideoCaptioningModel(port(cfg), 37)
    model.load_state_dict(sd)  # strict: names and shapes match the modules
    back = import_reference_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    if "init_state_projection" in params["decoder"]:
        # Port-only name: the upstream model has no such layer.
        proj = params["decoder"]["init_state_projection"]
        np.testing.assert_array_equal(sd["decoder.init_state_projection.weight"].numpy().T,
                                      np.asarray(proj["kernel"]))
        params["decoder"] = {k: v for k, v in params["decoder"].items()
                             if k != "init_state_projection"}
    want, got = _leaves_with_paths(params), _leaves_with_paths(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_init_params_numpy_matches_init_model_layout(tiny_config):
    cfg = tiny_config
    ours = init_params_numpy(port(cfg), 41, seed=0)
    ref = init_model(jax.random.PRNGKey(0), cfg, 41)
    want = [(p, np.asarray(x).shape) for p, x in _leaves_with_paths(ref)]
    got = [(p, np.asarray(x).shape) for p, x in _leaves_with_paths(ours)]
    assert got == want
    for _, x in _leaves_with_paths(ours):
        assert x.dtype == np.float32 and np.isfinite(x).all()
    dec = ours["decoder"]
    w_hh = dec["lstm"][0]["w_hh"]  # orthogonal (4H, H) stored transposed
    np.testing.assert_allclose(w_hh @ w_hh.T, np.eye(w_hh.shape[0]), atol=1e-5)
    assert not dec["lstm"][0]["b_ih"].any()
    assert np.abs(dec["embedding"]["table"]).max() <= 0.1
    np.testing.assert_array_equal(init_params_numpy(port(cfg), 41, seed=0)["encoder"]
                                  ["feature_projection"]["kernel"],
                                  ours["encoder"]["feature_projection"]["kernel"])


def _vocab(cfg, vocabulary_class=Vocabulary):
    cfg.data.vocab_threshold = 1
    vocab = vocabulary_class(cfg)
    vocab.build_vocabulary(["a man rides a horse", "a dog runs fast"])
    return vocab


def test_jax_written_package_loads_in_the_port(tiny_config, tmp_path):
    from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor

    cfg = tiny_config
    vocab = _vocab(cfg)
    params = init_model(jax.random.PRNGKey(5), cfg, len(vocab))
    path = CheckpointManager(tmp_path).save_model_for_inference(params, vocab, cfg)
    package = port_ckpt.load_model_for_inference(path)
    assert package["model_config"] == cfg.to_dict()
    pred = VideoCaptionPredictor(path, device="cpu")
    assert pred.vocabulary.word2idx == vocab.word2idx
    assert pred.vocabulary.idx2word == vocab.idx2word
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), port(cfg))
    got = pred.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_port_written_package_loads_in_jax(tiny_config, tmp_path):
    cfg = tiny_config
    cfg.data.vocab_threshold = 1
    pcfg = port(cfg)
    vocab = _vocab(pcfg, PortVocabulary)
    params = init_params_numpy(pcfg, len(vocab), seed=2)
    path = port_ckpt.save_model_for_inference(params, vocab, pcfg, tmp_path)
    assert (tmp_path / "model_config.json").exists()
    package = CheckpointManager(tmp_path).load_model_for_inference(path)
    restored = restore_params(package["model_state_dict"])
    for (pa, a), (pb, b) in zip(_leaves_with_paths(params), _leaves_with_paths(restored)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b))
    assert package["model_info"]["vocab_size"] == len(vocab)
    assert Config.from_dict(package["model_config"]).to_dict() == cfg.to_dict()


_NO_JAX_SCRIPT = r"""
import sys, tempfile
from pathlib import Path
import numpy as np, torch
from video_captioning_tpu_torch import Config, Vocabulary
from video_captioning_tpu_torch import generation
from video_captioning_tpu_torch.cli import serve, train  # noqa: F401
from video_captioning_tpu_torch.inference import predictor, server  # noqa: F401
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel
from video_captioning_tpu_torch.models.weights import init_params_numpy, state_dict_from_jax_params
cfg = Config()
m = cfg.model
m.cnn_feature_dim, m.encoder_hidden_dim, m.decoder_hidden_dim = 24, 16, 16
m.embedding_dim, m.attention_dim, m.attention_num_heads = 12, 16, 4
cfg.data.max_vocab_size = 29
cfg.validate()
model = VideoCaptioningModel(cfg, 29)
model.load_state_dict(state_dict_from_jax_params(init_params_numpy(cfg, 29), cfg))
x = torch.from_numpy(np.random.RandomState(0).randn(2, 10, 24).astype(np.float32))
with torch.inference_mode():
    for interpret in (False, True):
        cfg.kernels.interpret = interpret
        g = generation.generate(model, cfg, x, 1, 2, 6, method="greedy")
        b = generation.generate(model, cfg, x, 1, 2, 6, method="beam", beam_size=3)
        assert g["generated_tokens"].shape == (2, 6) and b["all_tokens"].shape == (2, 3, 7)
    # The fused decode-step configuration, its vocabulary gate forced.
    from video_captioning_tpu_torch.generation import beam as beam_mod
    fused = Config.from_dict(cfg.to_dict())
    for flag in ("use_pallas_attention", "use_pallas_lstm", "use_fused_vocab_topk"):
        setattr(fused.kernels, flag, True)
    beam_mod.fused_vocab_eligible = lambda *a: True
    g = generation.generate(model, fused, x, 1, 2, 6, method="greedy")
    b = generation.generate(model, fused, x, 1, 2, 6, method="beam", beam_size=3)
    assert g["generated_tokens"].shape == (2, 6) and b["all_tokens"].shape == (2, 3, 7)
# The transformer family, default and fused beam attention: a package
# written and served over HTTP.
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.inference.server import CaptionServer
from video_captioning_tpu_torch.utils.checkpoint import save_model_for_inference
import json, urllib.request
tcfg = Config.from_dict(cfg.to_dict())
tcfg.model.architecture = "transformer"
tcfg.model.embedding_dim, tcfg.model.transformer_num_heads = 16, 4
vocab = Vocabulary(tcfg)
vocab.build_vocabulary(["a man rides a horse"])
with tempfile.TemporaryDirectory() as tmp:
    pkg = save_model_for_inference(init_params_numpy(tcfg, len(vocab)), vocab, tcfg, tmp)
    for fused in (False, True):
        tcfg.kernels.transformer_fused_beam_attn = fused
        server = CaptionServer(VideoCaptionPredictor(pkg, config=tcfg, device="cpu"), port=0)
        server.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/caption",
                data=json.dumps({"features": x[0].tolist(), "method": "beam",
                                 "beam_size": 3, "max_length": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert isinstance(json.loads(resp.read())["caption"], str)
        finally:
            server.close()
# A CPU training step on each encoder path, a save and a resume.
rs = np.random.RandomState(0)
batch = {"video_features": rs.randn(2, 10, 24).astype(np.float32),
         "input_tokens": rs.randint(0, 29, (2, 6)).astype(np.int32),
         "target_tokens": rs.randint(0, 29, (2, 6)).astype(np.int32)}
for interpret in (False, True):
    cfg.kernels.interpret = interpret
    with tempfile.TemporaryDirectory() as tmp:
        cfg.experiment.checkpoint_dir = Path(tmp)
        trainer = VideoCaptioningTrainer(model, cfg, Vocabulary(cfg), None, None, device="cpu")
        assert np.isfinite(float(trainer.train_step(batch)))
        trainer._save(0, {}, is_best=True)
        trainer.load_checkpoint(Path(tmp) / "best_model.pth")
# Feature extraction: the int8 ResNet50 with the int8 1x1 kernels' flag
# (their plain versions on the CPU), and cli.convert_weights on a state file.
from video_captioning_tpu_torch.cli import convert_weights, preprocess  # noqa: F401
from video_captioning_tpu_torch.models.backbones import FeatureExtractor
from video_captioning_tpu_torch.models.weights import (backbone_state_dict_from_jax,
                                                       init_backbone_params_numpy)
fcfg = Config()
fcfg.kernels.int8_conv1x1_pallas = True
fx = FeatureExtractor("resnet50", fcfg, allow_random_init=True, variant="int8", batch_size=2,
                      device="cpu")
feats = fx.extract(np.random.RandomState(1).randint(0, 255, (2, 32, 32, 3), np.uint8))
assert feats.shape == (2, 2048) and np.isfinite(feats).all()
with tempfile.TemporaryDirectory() as tmp:
    state = backbone_state_dict_from_jax(init_backbone_params_numpy("resnet50"), "resnet50")
    np.savez(Path(tmp) / "state.npz", **{k: v.numpy() for k, v in state.items()})
    convert_weights.main(["--input", str(Path(tmp) / "state.npz"), "--model-type", "resnet50",
                          "--output", str(Path(tmp) / "r.vcw.npz")])
    assert convert_weights.is_native(Path(tmp) / "r.vcw.npz")
# A transformer training step (dropout on), then cli.predict, cli.evaluate
# and cli.import_reference on the CPU.
from video_captioning_tpu_torch.cli import evaluate, import_reference, predict
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    tcfg.experiment.checkpoint_dir = tmp / "ck"
    tmodel = VideoCaptioningModel(tcfg, len(vocab))
    tmodel.load_state_dict(state_dict_from_jax_params(init_params_numpy(tcfg, len(vocab)), tcfg))
    tbatch = {k: v % len(vocab) if k != "video_features" else v for k, v in batch.items()}
    trainer = VideoCaptioningTrainer(tmodel, tcfg, vocab, None, None, device="cpu")
    assert np.isfinite(float(trainer.train_step(tbatch)))
    params = init_params_numpy(cfg, len(vocab))
    pkg = save_model_for_inference(params, vocab, cfg, tmp)
    np.save(tmp / "f.npy", np.random.RandomState(0).randn(10, 24).astype(np.float32))
    predict.main(["--model-path", str(pkg), "--device", "cpu", "--log-level", "WARNING",
                  "--method", "beam", "--beam-size", "2", "multiple", "--video-path", "v.mp4",
                  "--features-path", str(tmp / "f.npy"), "--num-captions", "2",
                  "--output", str(tmp / "m.json")])
    assert len(json.loads((tmp / "m.json").read_text())["captions"]) == 2
    (tmp / "p.txt").write_text("a man rides\n")
    (tmp / "r.txt").write_text("a man rides a horse\n")
    assert "bleu_4" in evaluate.main(["--predictions", str(tmp / "p.txt"), "--references",
                                      str(tmp / "r.txt"), "--log-level", "WARNING"])
    torch.save(state_dict_from_jax_params(params, cfg), tmp / "state.pth")
    vocab.save(tmp / "vocabulary.json")
    (tmp / "base.json").write_text(json.dumps(cfg.to_dict()))
    summary = import_reference.main(["--input", str(tmp / "state.pth"), "--output-dir",
                                     str(tmp / "out"), "--vocabulary", str(tmp / "vocabulary.json"),
                                     "--config", str(tmp / "base.json"), "--log-level", "WARNING"])
    assert VideoCaptionPredictor(summary["output"], device="cpu").predict_from_features(
        np.load(tmp / "f.npy"))["caption"] is not None
# A Luong model served by every method, sampling included, and a bfloat16
# predictor.
with tempfile.TemporaryDirectory() as tmp:
    lcfg = Config.from_dict(cfg.to_dict())
    lcfg.model.attention_type = "luong"
    lcfg.kernels.interpret = False
    pkg = save_model_for_inference(init_params_numpy(lcfg, len(vocab)), vocab, lcfg, tmp)
    lp = VideoCaptionPredictor(pkg, device="cpu")
    for method in ("greedy", "beam", "sample"):
        assert lp.predict_from_features(x[0].numpy(), method=method, max_length=6)["caption"] \
            is not None
    lp16 = VideoCaptionPredictor(pkg, device="cpu", compute_dtype="bfloat16")
    assert len(lp16.predict_batch([x[0].numpy(), x[1].numpy()], method="beam",
                                  max_length=6)) == 2
# W8A8 decode (both levels, both families) and a bfloat16 training step on
# a batch from the native loader.
from video_captioning_tpu_torch import native
from video_captioning_tpu_torch.data.pipeline import VideoCaptioningDataset
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    for c in (cfg, tcfg):
        c.kernels.interpret = False
        pkg = save_model_for_inference(init_params_numpy(c, len(vocab)), vocab, c, tmp)
        for level in ("vocab", "full"):
            q = VideoCaptionPredictor(pkg, device="cpu", decode_int8=level)
            assert len(q.predict_batch([x[0].numpy(), x[1].numpy()], method="beam",
                                       max_length=6)) == 2
    rows = []
    for i in range(4):
        np.save(tmp / f"n{i}.npy", np.random.RandomState(i).randn(12, 24).astype(np.float32))
        rows.append({"video_id": f"n{i}", "video_path": "", "feature_path": str(tmp / f"n{i}.npy"),
                     "caption": "a man rides a horse"})
    bcfg = Config.from_dict(cfg.to_dict())
    bcfg.training.compute_dtype = "bfloat16"
    bcfg.data.frames_per_video = 10
    bcfg.experiment.checkpoint_dir = tmp / "bf16"
    ds = VideoCaptioningDataset(rows, vocab, bcfg)
    nb = ds.get_batch([0, 1, 2, 3])
    assert native.native_available() and ds.native_batches == 1
    nb = {k: v % len(vocab) if k in ("input_tokens", "target_tokens") else v
          for k, v in nb.items()}
    bmodel = VideoCaptioningModel(bcfg, len(vocab))
    bmodel.load_state_dict(state_dict_from_jax_params(init_params_numpy(bcfg, len(vocab)), bcfg))
    btrainer = VideoCaptioningTrainer(bmodel, bcfg, vocab, None, None, device="cpu")
    assert np.isfinite(float(btrainer.train_step(nb)))
    assert all(p.dtype == torch.float32 for p in bmodel.parameters())
# A .vcx exported by cli.export, served by ExportedPredictor in a process
# that loads no model code, and a data-parallel step over two gloo ranks
# (dryrun_multihost: each rank's shard, rank 0's checkpoint, the replay).
import subprocess
from video_captioning_tpu_torch.cli import export as export_cli
from video_captioning_tpu_torch.parallel import dryrun_multihost
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    pkg = save_model_for_inference(init_params_numpy(cfg, len(vocab)), vocab, cfg, tmp)
    vcx = export_cli.main(["--model-path", str(pkg), "--output", str(tmp / "m.vcx"),
                           "--batch-sizes", "2", "--method", "beam", "--beam-size", "2",
                           "--max-length", "4", "--device", "cpu", "--log-level", "WARNING"])
    serve_vcx = (
        "import sys, numpy as np\n"
        "from video_captioning_tpu_torch.inference.export import ExportedPredictor\n"
        "p = ExportedPredictor(sys.argv[1], device='cpu')\n"
        "assert len(p.predict_batch([np.zeros((10, 24), np.float32)] * 3)) == 3\n"
        "print(sorted(n for n in sys.modules if n == 'jax' or n.startswith(("
        "'video_captioning_tpu.', 'video_captioning_tpu_torch.models'))))\n")
    res = subprocess.run([sys.executable, "-c", serve_vcx, str(vcx)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout
    assert dryrun_multihost(2, workdir=tmp / "dp")["ok"]
print("JAX_LOADED=" + str("jax" in sys.modules))
print("JAX_PACKAGE_MODULES=" + ",".join(sorted(
    n for n in sys.modules if n == "video_captioning_tpu" or n.startswith("video_captioning_tpu."))))
"""


def test_port_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED=False" in proc.stdout
    assert "JAX_PACKAGE_MODULES=\n" in proc.stdout


DECODE_KERNEL_FLAGS = ("use_pallas_attention", "use_pallas_lstm", "use_fused_vocab_topk")


@pytest.mark.parametrize("flags", [(f,) for f in DECODE_KERNEL_FLAGS] + [DECODE_KERNEL_FLAGS])
def test_decode_kernel_flags_build_and_leave_training_unchanged(tiny_config, tmp_path, flags):
    """Each decode-step kernel flag builds the model; in training
    (``train=True``) the flags change nothing, as in the JAX package: one
    trainer step with them on equals the step with them off exactly."""
    from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer

    rs = np.random.RandomState(0)
    batch = {"video_features": rs.randn(2, 10, 24).astype(np.float32),
             "input_tokens": rs.randint(0, 20, (2, 6)).astype(np.int32),
             "target_tokens": rs.randint(0, 20, (2, 6)).astype(np.int32)}
    sd = state_dict_from_jax_params(init_params_numpy(port(tiny_config), 20, seed=1),
                                    port(tiny_config))
    results = []
    for on in (False, True):
        cfg = port(tiny_config)
        cfg.experiment.checkpoint_dir = tmp_path / str(on)
        cfg.experiment.use_tensorboard = False
        for flag in flags:
            setattr(cfg.kernels, flag, on)
        model = VideoCaptioningModel(cfg, 20)
        model.load_state_dict(sd)
        trainer = VideoCaptioningTrainer(model, cfg, PortVocabulary(cfg), None, None,
                                         device="cpu")
        loss = trainer.train_step(batch)
        results.append((loss, {k: v.clone() for k, v in model.state_dict().items()}))
    (loss_off, sd_off), (loss_on, sd_on) = results
    assert torch.isfinite(loss_on) and torch.equal(loss_on, loss_off)
    for k in sd_off:
        assert torch.equal(sd_on[k], sd_off[k]), k


def test_port_raises_on_what_it_does_not_run(tiny_config, tmp_path):
    from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor

    # The transformer family builds, with context parallelism and with
    # bfloat16 cross keys/values too; an architecture the port does not
    # know is refused.
    for section, field, value in (("kernels", "transformer_cross_kv_bf16", True),
                                  ("parallel", "context_axis", "model")):
        cfg = port(tiny_config)
        cfg.model.architecture = "transformer"
        cfg.model.embedding_dim = cfg.model.decoder_hidden_dim
        VideoCaptioningModel(cfg, 20)
        setattr(getattr(cfg, section), field, value)
        VideoCaptioningModel(cfg, 20)
    cfg = port(tiny_config)
    cfg.model.architecture = "gru"
    with pytest.raises(NotImplementedError, match="not ported.*architecture='gru'"):
        VideoCaptioningModel(cfg, 20)
    # bfloat16 serving, with each fused decode-step flag too.
    cfg = port(tiny_config)
    vocab = PortVocabulary(cfg)
    vocab.build_vocabulary(["a man rides a horse"])
    pkg = port_ckpt.save_model_for_inference(init_params_numpy(cfg, len(vocab)), vocab, cfg,
                                             tmp_path)
    VideoCaptionPredictor(pkg, device="cpu", compute_dtype="bfloat16")
    for flag in DECODE_KERNEL_FLAGS:
        fused = PortConfig.from_dict(cfg.to_dict())
        setattr(fused.kernels, flag, True)
        VideoCaptionPredictor(pkg, config=fused, device="cpu", compute_dtype="bfloat16")
    # The transformer in bfloat16 with bfloat16 cross keys/values serves.
    tcfg = port(tiny_config)
    tcfg.model.architecture = "transformer"
    tcfg.model.embedding_dim = tcfg.model.decoder_hidden_dim
    tcfg.kernels.transformer_cross_kv_bf16 = True
    (tmp_path / "transformer").mkdir()
    tpkg = port_ckpt.save_model_for_inference(init_params_numpy(tcfg, len(vocab)), vocab, tcfg,
                                              tmp_path / "transformer")
    tp = VideoCaptionPredictor(tpkg, device="cpu", compute_dtype="bfloat16")
    for method in ("greedy", "beam"):
        assert tp.predict_from_features(np.zeros((10, 24), np.float32), method=method,
                                        max_length=4)["tokens"]
    # W8A8 decode is ported; an unknown level is refused with the JAX message.
    with pytest.raises(ValueError, match="decode_int8 must be one of"):
        VideoCaptionPredictor(pkg, device="cpu", decode_int8="int4")
    # A .vcx artifact loads as its ExportedPredictor (tests/test_torch_export.py);
    # the arguments it cannot honour are refused before the file is read.
    with pytest.raises(ValueError, match="vcx.*single-device"):
        VideoCaptionPredictor(tmp_path / "m.vcx", mesh=object())
