"""bfloat16 serving artifacts (``.vcx`` with ``compute_dtype="bfloat16"``)
of the port against the JAX package's on the CPU.

The JAX artifact's programs take bfloat16 features: its exporter traces
them with a bfloat16 input spec and its ``ExportedPredictor`` casts each
batch (``inference/export.py:126``, ``:476-479``), so every activation of
a bfloat16 artifact is bfloat16. The port's does the same: its programs
are traced with bfloat16 features and its ``ExportedPredictor`` casts them.

* The LSTM family (the bahdanau model of tests/test_torch_bf16.py): the
  program receives bfloat16 features; the encoder outputs on those
  features within 2e-2 of the largest value of JAX's; the artifact's
  tokens equal to the port's live decode of the same bfloat16 features;
  greedy clip agreement with JAX's artifact at least 0.9 on 64 sharpened
  clips, END suppressed (beam-5's printed).
* The transformer with ``transformer_fused_beam_attn`` and
  ``transformer_bf16_beam_state``: the same gate, and its beam program's
  ``vct::beam_self_attention`` and ``vct::beam_cross_attention`` nodes
  take a bfloat16 query and give bfloat16 outputs.
* ``opcheck`` of the two attention ops with a bfloat16 query.
"""

import io
import zipfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bf16 import _config, _near, _package, _port
from video_captioning_tpu.inference.export import ExportedPredictor as JaxExportedPredictor
from video_captioning_tpu.inference.export import export_serving_artifact as jax_export
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu_torch.generation.greedy import greedy_generate
from video_captioning_tpu_torch.inference.export import ExportedPredictor, export_serving_artifact
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models.captioner import encode
from video_captioning_tpu_torch.ops import library

MIN_GREEDY_AGREEMENT = 0.9
CLIPS = 64
MAX_LENGTH = 8


def _transformer_config():
    cfg = _config()
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim, cfg.model.transformer_num_heads = 16, 4
    cfg.kernels.transformer_fused_beam_attn = True
    cfg.kernels.transformer_bf16_beam_state = True
    cfg.kernels.interpret = True  # the JAX Pallas kernels on the CPU
    cfg.validate()
    return cfg


def _artifacts(tmp_path, cfg, method):
    """The same package exported in bfloat16 by both packages, one bucket of
    CLIPS clips: (JAX predictor, port predictor, port artifact path)."""
    pkg = _package(tmp_path, cfg, seed=3, end_bias=-1e9)
    kw = dict(batch_sizes=[CLIPS], method=method, max_length=MAX_LENGTH, beam_size=5,
              compute_dtype="bfloat16", platforms=["cpu"])
    j_out = jax_export(pkg, tmp_path / f"jax_{method}.vcx", **kw)
    t_out = export_serving_artifact(pkg, tmp_path / f"port_{method}.vcx", **kw)
    return pkg, JaxExportedPredictor(j_out), ExportedPredictor(t_out, device="cpu"), t_out


def _program(path, bucket=CLIPS):
    """The saved ``torch.export`` program of one bucket."""
    with zipfile.ZipFile(path) as zf:
        return torch.export.load(io.BytesIO(zf.read(f"program_b{bucket}_cpu.pt2")))


def _serve_recording_inputs(aot, feats):
    """Serve ``feats`` and return (records, the dtypes the program got)."""
    seen = []
    load = aot._load_program

    def spying(table, bucket):
        program = load(table, bucket)

        def call(x):
            seen.append(x.dtype)
            return program(x)
        return call

    with mock.patch.object(aot, "_load_program", spying):
        records = aot.predict_batch(feats)
    return records, seen


def _agreement(got, want):
    return float(np.mean([a["tokens"] == b["tokens"] for a, b in zip(got, want)]))


def _clips(cfg, seed=7):
    return np.random.RandomState(seed).randn(CLIPS, 10, cfg.model.cnn_feature_dim).astype(
        np.float32)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_bf16_lstm_vcx_casts_its_features_as_the_jax_artifact(tmp_path, method):
    cfg = _config()
    pkg, j_aot, t_aot, t_out = _artifacts(tmp_path, cfg, method)
    feats = _clips(cfg)
    got, dtypes = _serve_recording_inputs(t_aot, feats)
    assert dtypes == [torch.bfloat16]
    user_input = _program(t_out).graph_signature.user_inputs[0]
    node = next(n for n in _program(t_out).graph.nodes if n.name == user_input)
    assert node.meta["val"].dtype == torch.bfloat16
    want = j_aot.predict_batch(feats)
    agreement = _agreement(got, want)
    print(f"bf16 LSTM .vcx {method}: clip agreement with JAX's bf16 artifact on {CLIPS} "
          f"sharpened clips {agreement}")
    if method == "beam":
        return
    assert agreement >= MIN_GREEDY_AGREEMENT
    # What the program traced: encode and greedy on the bfloat16 features,
    # through the bfloat16 weights.
    jp = JaxPredictor(Path(pkg), compute_dtype="bfloat16")
    tp = VideoCaptionPredictor(pkg, config=_port(cfg), device="cpu", compute_dtype="bfloat16")
    f16 = torch.from_numpy(feats).to(torch.bfloat16)
    with torch.no_grad():
        enc, final, mask = encode(tp.model, tp.config, f16)
        live = greedy_generate(tp.model, tp.config, enc, final, tp.vocabulary.start_idx,
                               tp.vocabulary.end_idx, MAX_LENGTH, mask)["generated_tokens"]
    j_enc, _, _ = j_cap.encode(jp.params, cfg, jnp.asarray(feats).astype(jnp.bfloat16))
    assert enc.dtype == torch.bfloat16 and j_enc.dtype == jnp.bfloat16
    _near(enc, j_enc, "encoder outputs on the bfloat16 features")
    assert [r["tokens"] for r in got] == live.tolist()


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_bf16_fused_transformer_vcx_matches_the_jax_artifact(tmp_path, method):
    cfg = _transformer_config()
    _, j_aot, t_aot, t_out = _artifacts(tmp_path, cfg, method)
    feats = _clips(cfg, seed=9)
    got, dtypes = _serve_recording_inputs(t_aot, feats)
    assert dtypes == [torch.bfloat16]
    agreement = _agreement(got, j_aot.predict_batch(feats))
    print(f"bf16 fused transformer .vcx {method}: clip agreement with JAX's bf16 artifact on "
          f"{CLIPS} sharpened clips {agreement}")
    if method == "greedy":
        assert agreement >= MIN_GREEDY_AGREEMENT
        return
    ops = {"beam_self_attention": torch.ops.vct.beam_self_attention.default,
           "beam_cross_attention": torch.ops.vct.beam_cross_attention.default}
    seen = {name: 0 for name in ops}
    for node in _program(t_out).graph.nodes:
        for name, op in ops.items():
            if node.target is op:
                seen[name] += 1
                outs = node.meta["val"]
                outs = outs if isinstance(outs, (tuple, list)) else (outs,)
                assert node.args[0].meta["val"].dtype == torch.bfloat16, name
                assert all(o.dtype == torch.bfloat16 for o in outs), name
    layers = cfg.model.transformer_decoder_layers
    assert seen == {name: layers * MAX_LENGTH for name in ops}


def test_attention_ops_opcheck_with_a_bfloat16_query():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    N, K, D, S = 6, 3, 16, 5
    mask = torch.ones(2, S)
    mask[1, 3:] = 0
    anc = torch.zeros(N // K, K, 4, dtype=torch.int32)
    cases = {library.beam_self_attention_op: (r(N, D), r(4, N, D), r(4, N, D), anc, 2, 4, K),
             library.beam_cross_attention_op: (r(N, D), r(2, S, D), r(2, S, D), mask, 4, K)}
    for op, args in cases.items():
        torch.library.opcheck(op, args)
        out = op(*args)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.dtype == torch.bfloat16 for o in outs)
