"""bfloat16 serving of the transformer family (``compute_dtype="bfloat16"``)
and ``kernels.transformer_cross_kv_bf16`` in the port against the JAX
package on the CPU.

* The two beam-attention kernels' plain versions with a bfloat16 query
  (the bfloat16 beam state's) against the Pallas kernels in interpret
  mode: every bfloat16 output within one bfloat16 ulp of JAX's, and the
  head-mean weights rounded as the JAX kernel's grid rounds them (a block
  of heads at a time).
* Every arm of the JAX dtype policy (``generation/families.py``): greedy;
  beam with ``transformer_beam_params_f32`` (the default), with
  ``transformer_bf16_beam_state`` and with ``transformer_beam_params_f32``
  off; each of the three under ``transformer_fused_beam_attn``; beam under
  ``transformer_fused_cross_attn`` alone; greedy and
  ``transformer_bf16_beam_state`` with ``transformer_attn_dots_f32``; all of
  them with ``transformer_cross_kv_bf16`` too; with float32 features (the live
  predictor) and bfloat16 features (the bfloat16 ``.vcx``). Encoder
  outputs, decode-step logits and caches within 2e-2 of the largest JAX
  value (``tests/test_torch_bf16.py``'s tolerance), in JAX's dtypes;
  teacher-forced logits likewise.
* ``transformer_cross_kv_bf16`` under float32 serving, K = 1 and 5: logits
  within 1e-4 of the largest value, tokens identical on 16 sharpened clips.
* Tokens on 64 sharpened clips, END suppressed (the protocol of
  ``benchmarks/bf16_parity_gate.py``): greedy clip agreement with JAX's
  bfloat16 run at least 0.9; beam-5's printed (bfloat16 beams diverge on
  near ties).
* The trainer's bfloat16 validation decode of the transformer (bfloat16
  features and weights, as the JAX trainer's ``gen_step``) against JAX's:
  greedy agreement at least 0.9 on 64 sharpened clips.

JAX runs its Pallas kernels in interpret mode (``kernels.interpret``) and
its decode steps under ``jax.jit`` (its operand-layout cross-attention's
bfloat16 dots do not run op by op on the CPU); the port runs the plain
versions. The bfloat16 ``.vcx`` is held in tests/test_torch_bf16_vcx.py.
"""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bf16 import _config, _near, _package, _port
from video_captioning_tpu.generation import families as j_fam
from video_captioning_tpu.generation import greedy_generate as j_greedy
from video_captioning_tpu.inference.predictor import VideoCaptionPredictor as JaxPredictor
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.ops.transformer_attn_pallas import (
    beam_cross_attention as j_beam_cross,
    beam_self_attention as j_beam_self,
)
from video_captioning_tpu_torch.data.vocabulary import Vocabulary
from video_captioning_tpu_torch.generation import families as t_fam
from video_captioning_tpu_torch.inference.predictor import VideoCaptionPredictor
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model, encode
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params
from video_captioning_tpu_torch.ops.transformer_attn import (
    beam_cross_attention,
    beam_cross_attention_reference,
    beam_self_attention,
    beam_self_attention_reference,
    head_mean,
    heads_per_block,
)
from video_captioning_tpu_torch.training import trainer as t_trainer
from video_captioning_tpu_torch.training.trainer import VideoCaptioningTrainer

MIN_GREEDY_AGREEMENT = 0.9
F32_SERVING_ATOL = 1e-4
# The JAX dtype policy's arms: (beams, kernel flags).
ARMS = {
    "greedy": (1, {}),
    "beam_params_f32": (5, {}),
    "bf16_beam_state": (5, {"transformer_bf16_beam_state": True}),
    "beam_params_f32_off": (5, {"transformer_beam_params_f32": False}),
    "fused_params_f32": (5, {"transformer_fused_beam_attn": True}),
    "fused_bf16_beam_state": (5, {"transformer_fused_beam_attn": True,
                                  "transformer_bf16_beam_state": True}),
    "fused_params_f32_off": (5, {"transformer_fused_beam_attn": True,
                                 "transformer_beam_params_f32": False}),
    # The cross-attention kernel alone (its JAX step takes the plain
    # operand-layout step instead under transformer_cross_kv_bf16).
    "fused_cross_only": (5, {"transformer_fused_cross_attn": True}),
    # transformer_attn_dots_f32: the plain attention's operands not rounded
    # to the stored dtype (but the operand-layout cross step's).
    "greedy_attn_dots_f32": (1, {"transformer_attn_dots_f32": True}),
    "bf16_beam_state_attn_dots_f32": (5, {"transformer_bf16_beam_state": True,
                                          "transformer_attn_dots_f32": True}),
}


def _tr_config(flags=(), cross_kv_bf16=False):
    """tests/test_torch_bf16.py's small model as a transformer: D = 16,
    4 heads, 2 + 2 blocks, V = 20, 10 frames."""
    cfg = _config()
    cfg.model.architecture = "transformer"
    cfg.model.embedding_dim, cfg.model.transformer_num_heads = 16, 4
    cfg.kernels.interpret = True
    cfg.kernels.transformer_cross_kv_bf16 = cross_kv_bf16
    for flag, value in dict(flags).items():
        setattr(cfg.kernels, flag, value)
    cfg.validate()
    return cfg


def _predictors(pkg, cfg, compute_dtype="bfloat16"):
    jp = JaxPredictor(Path(pkg), config=cfg, compute_dtype=compute_dtype)
    tp = VideoCaptionPredictor(pkg, config=_port(cfg), device="cpu",
                               compute_dtype=compute_dtype)
    return jp, tp


def _bf16_ulps(got, want) -> np.ndarray:
    """|got - want| in units of the bfloat16 spacing at want."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    mag = np.maximum(np.abs(w), np.float32(2.0 ** -126))
    return np.abs(g - w) / np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_ulp(got, want, what):
    ulps = _bf16_ulps(got, want)
    print(f"{what}: {int((ulps > 0).sum())} of {ulps.size} bfloat16 outputs differ from JAX's "
          f"(at most {ulps.max():g} ulp)")
    assert ulps.max() <= 1.0, what


# --------------------------------------------------------------- kernels


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, order="C"))


def _bf16(a):
    """A float32 array rounded to bfloat16, as (jax, torch) arrays."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [0, 4, 8])
@pytest.mark.parametrize("D", [16, 256])
def test_bf16_query_self_attention_plain_version_matches_pallas(D, t, cache_dtype):
    """A bfloat16 query (B = 3, K = 2, 4 heads, T = 9): the context in
    bfloat16, rounded once from the float32 result on both sides."""
    B, K, T, H = 3, 2, 9, 4
    rs = np.random.RandomState(100 * D + 10 * t)
    q = rs.randn(B * K, D).astype(np.float32)
    k, v = (rs.randn(T, B * K, D).astype(np.float32) for _ in range(2))
    anc = rs.randint(0, K, (B, K, T)).astype(np.int32)
    anc[:, :, t] = np.arange(K)
    jq, tq = _bf16(q)
    jk, jv = (jnp.asarray(c).astype(cache_dtype) for c in (k, v))
    tk, tv = (_t(np.asarray(c.astype(jnp.float32))).to(getattr(torch, cache_dtype))
              for c in (jk, jv))
    want = j_beam_self(jq, jk, jv, jnp.asarray(anc), jnp.int32(t), H, K, interpret=True)
    got = beam_self_attention_reference(tq, tk, tv, _t(anc), t, H, K)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _within_one_ulp(got, want, f"beam_self_attention D={D} t={t} {cache_dtype} caches")
    assert torch.equal(beam_self_attention(tq, tk, tv, _t(anc), t, H, K), got)


@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
@pytest.mark.parametrize("D", [16, 256])
def test_bf16_query_cross_attention_plain_version_matches_pallas(D, mask_kind):
    """A bfloat16 query with bfloat16 keys and values (B = 3, K = 2,
    4 heads, S = 10; at D = 256 the JAX grid takes the heads in two blocks
    of two): context and head-mean weights in bfloat16."""
    B, K, S, H = 3, 2, 10, 4
    rs = np.random.RandomState(D + len(mask_kind))
    jq, tq = _bf16(rs.randn(B * K, D).astype(np.float32))
    (jk, tk), (jv, tv) = (_bf16(rs.randn(B, S, D).astype(np.float32)) for _ in range(2))
    mask = None
    if mask_kind == "ragged":
        mask = (np.arange(S)[None, :] < np.array([10, 3, 7])[:, None]).astype(np.float32)
    want = j_beam_cross(jq, jk, jv, None if mask is None else jnp.asarray(mask), H, K,
                        interpret=True)
    got = beam_cross_attention_reference(tq, tk, tv, _t(mask), H, K)
    for name, g, w in zip(("context", "weights"), got, want):
        assert w.dtype == jnp.bfloat16 and g.dtype == torch.bfloat16
        _within_one_ulp(g, w, f"beam_cross_attention D={D} {mask_kind} mask: {name}")
    for a, b in zip(beam_cross_attention(tq, tk, tv, _t(mask), H, K), got):
        assert torch.equal(a, b)


def test_bf16_head_mean_follows_the_head_blocks():
    """At D = 256 and 4 heads the JAX kernel averages heads {0, 1} and
    {2, 3} in two grid steps, rounding each part and their sum to bfloat16.
    On weights where that and one rounded mean differ, the plain version
    gives JAX's value, not the mean's."""
    B, K, S, H, D = 4, 5, 40, 4, 256
    assert heads_per_block(D, H) == 2 and heads_per_block(16, H) == H
    rs = np.random.RandomState(3)
    jq, tq = _bf16(3.0 * rs.randn(B * K, D).astype(np.float32))
    (jk, tk), (jv, tv) = (_bf16(rs.randn(B, S, D).astype(np.float32)) for _ in range(2))
    _, want = j_beam_cross(jq, jk, jv, None, H, K, interpret=True)
    _, got = beam_cross_attention_reference(tq, tk, tv, None, H, K)
    # The float32 per-head weights, as the plain version computes them.
    dh = D // H
    scores = torch.einsum("bkhd,bshd->bkhs", tq.float().reshape(B, K, H, dh),
                          tk.float().reshape(B, S, H, dh)) / dh ** 0.5
    w = torch.softmax(scores, dim=-1)
    one_mean = w.mean(dim=2).to(torch.bfloat16).reshape(B * K, S)
    assert torch.equal(head_mean(w, torch.bfloat16, 2).reshape(B * K, S), got)
    differ = (one_mean != got).numpy()
    want_np = np.asarray(want.astype(jnp.float32))
    print(f"head mean: one rounded mean and the blockwise rounding differ at "
          f"{int(differ.sum())} of {differ.size} weights")
    assert differ.sum() > 0
    np.testing.assert_array_equal(got.float().numpy()[differ], want_np[differ])


# ------------------------------------------------------------ the arms


def _decode_steps(jfam, tfam, K, steps=3):
    """``steps`` decode steps of both families on the same tokens (a
    rebeam after each beam step). Yields (t, JAX logits, port logits)."""
    js, ts = jfam.state0, tfam.state0
    j_step, j_step_beam = jax.jit(jfam.step), jax.jit(jfam.step_beam)
    toks = np.array([[1, 5, 7, 9, 3][:K], [2, 4, 6, 8, 10][:K]])
    beam_idx = np.array([[0, 0, 1, 2, 1], [4, 3, 2, 1, 0]])
    for t in range(steps):
        tok = (toks + t) % 20
        if K == 1:
            jl, js, _ = j_step(jnp.asarray(tok[:, 0], jnp.int32), js, jnp.int32(t))
            with torch.no_grad():
                tl, ts, _ = tfam.step(_t(tok[:, 0]).long(), ts, t)
        else:
            jl, js, _ = j_step_beam(jnp.asarray(tok, jnp.int32), js, jnp.int32(t))
            with torch.no_grad():
                tl, ts, _ = tfam.step_beam(_t(tok).long(), ts, t)
            js = jfam.rebeam(js, jnp.asarray(beam_idx[:, :, None] == np.arange(K)))
            ts = tfam.rebeam(ts, _t(beam_idx).long())
        yield t, jl, tl, js, ts


@pytest.mark.parametrize("cross_kv_bf16", [False, True])
@pytest.mark.parametrize("features", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_bf16_transformer_arm_matches_jax(tmp_path, arm, features, cross_kv_bf16):
    """Two clips, the second with 4 valid frames; three decode steps of the
    arm's family on both sides: encoder outputs, logits and every layer's
    caches within 2e-2 of the largest JAX value, each in JAX's dtype."""
    K, flags = ARMS[arm]
    cfg = _tr_config(flags, cross_kv_bf16)
    jp, tp = _predictors(_package(tmp_path, cfg), cfg)
    assert all(p.dtype == torch.bfloat16 for p in tp.model.parameters())
    rs = np.random.RandomState(1)
    feats = rs.randn(2, 10, 24).astype(np.float32)
    mask = np.ones((2, 10), np.float32)
    mask[1, 4:] = 0.0
    jf = jnp.asarray(feats).astype(features)
    tf = torch.from_numpy(feats).to(getattr(torch, features))
    je, jfin, jm = j_cap.encode(jp.params, cfg, jf, jnp.asarray(mask))
    with torch.no_grad():
        te, tfin, tm = encode(tp.model, tp.config, tf, torch.from_numpy(mask))
    assert str(te.dtype).split(".")[1] == str(je.dtype) == features
    _near(te, je, "encoder outputs")
    jfam = j_fam.make_decode_family(jp.params, cfg, je, jfin, jm, num_beams=K, max_length=8)
    with torch.no_grad():
        tfam = t_fam.make_decode_family(tp.model, tp.config, te, tfin, tm, num_beams=K,
                                        max_length=8)
    for t, jl, tl, js, ts in _decode_steps(jfam, tfam, K):
        assert str(tl.dtype).split(".")[1] == str(jl.dtype), (tl.dtype, jl.dtype)
        _near(tl, jl, f"step {t} logits")
        for i in range(cfg.model.transformer_decoder_layers):
            for name in ("k", "v"):
                jc, tc = js[name][i], ts[name][i]
                assert str(tc.dtype).split(".")[1] == str(jc.dtype)
                _near(tc, jc, f"step {t} layer {i} {name} cache")


@pytest.mark.parametrize("features", ["float32", "bfloat16"])
def test_bf16_transformer_teacher_forcing_matches_jax(tmp_path, features):
    cfg = _tr_config()
    jp, tp = _predictors(_package(tmp_path, cfg), cfg)
    rs = np.random.RandomState(2)
    feats = rs.randn(3, 10, 24).astype(np.float32)
    inp = rs.randint(0, 20, (3, 6)).astype(np.int32)
    want = j_cap.apply_model(jp.params, cfg, jnp.asarray(feats).astype(features),
                             jnp.asarray(inp))
    with torch.no_grad():
        got = apply_model(tp.model, tp.config, torch.from_numpy(feats).to(getattr(torch, features)),
                          torch.from_numpy(inp).long())
    assert str(got["logits"].dtype).split(".")[1] == str(want["logits"].dtype)
    _near(got["logits"], want["logits"], "teacher-forced logits")
    _near(got["attention_weights"], want["attention_weights"], "cross-attention weights")


F32_SERVING_FLAGS = {
    "plain": {},
    "attn_dots_f32": {"transformer_attn_dots_f32": True, "transformer_cache_bf16": True},
    "fused_cross_only": {"transformer_fused_cross_attn": True},
}


@pytest.mark.parametrize("flags", list(F32_SERVING_FLAGS))
@pytest.mark.parametrize("K", [1, 5])
def test_cross_kv_bf16_float32_serving_matches_jax(tmp_path, K, flags):
    """Float32 parameters and features with bfloat16 cross keys and values:
    three steps' logits within 1e-4 of the largest JAX value (a package
    whose END logit is not suppressed, so the largest value is a logit's
    own scale), and the predictor's tokens (greedy at K = 1, beam-5 at
    K = 5) identical to the JAX predictor's on 16 sharpened clips, END
    suppressed. With ``transformer_attn_dots_f32`` and bfloat16 caches
    too, the queries and softmax weights go into the attention products
    unrounded, but the beam step's operand-layout cross-attention rounds
    them (rounding them everywhere fails this tolerance); that plain step
    also runs in place of the cross-attention kernel under
    ``transformer_fused_cross_attn``."""
    cfg = _tr_config(F32_SERVING_FLAGS[flags], cross_kv_bf16=True)
    jp, tp = _predictors(_package(tmp_path / "steps", cfg, seed=3), cfg, compute_dtype=None)
    feats = np.random.RandomState(4).randn(2, 10, 24).astype(np.float32)
    je, jfin, jm = j_cap.encode(jp.params, cfg, jnp.asarray(feats))
    with torch.no_grad():
        te, tfin, tm = encode(tp.model, tp.config, torch.from_numpy(feats))
        tfam = t_fam.make_decode_family(tp.model, tp.config, te, tfin, tm, num_beams=K,
                                        max_length=8)
    jfam = j_fam.make_decode_family(jp.params, cfg, je, jfin, jm, num_beams=K, max_length=8)
    for t, jl, tl, _, _ in _decode_steps(jfam, tfam, K):
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                                   atol=F32_SERVING_ATOL * float(np.abs(want).max()),
                                   err_msg=f"step {t} logits")
    jp, tp = _predictors(_package(tmp_path / "tokens", cfg, seed=3, end_bias=-1e9), cfg,
                         compute_dtype=None)
    clips = [c for c in np.random.RandomState(5).randn(16, 10, 24).astype(np.float32)]
    method = "greedy" if K == 1 else "beam"
    want = [r["tokens"] for r in jp.predict_batch(clips, method=method, max_length=8)]
    got = [r["tokens"] for r in tp.predict_batch(clips, method=method, max_length=8)]
    assert got == want


@pytest.mark.parametrize("arm", ["beam_params_f32", "fused_bf16_beam_state"])
def test_bf16_transformer_clip_agreement_with_jax(tmp_path, arm):
    """64 clips, the protocol of benchmarks/bf16_parity_gate.py (vocabulary
    projection sharpened x3, END suppressed): greedy clip agreement with
    JAX's bfloat16 run >= 0.9; beam-5's is printed."""
    cfg = _tr_config(ARMS[arm][1])
    pkg = _package(tmp_path, cfg, seed=3, end_bias=-1e9)
    jp, tp = _predictors(pkg, cfg)
    clips = [c for c in np.random.RandomState(7).randn(64, 10, 24).astype(np.float32)]
    agreement = {}
    for method in ("greedy", "beam"):
        want = np.array([r["tokens"] for r in jp.predict_batch(clips, method=method,
                                                                max_length=8)])
        got = np.array([r["tokens"] for r in tp.predict_batch(clips, method=method,
                                                               max_length=8)])
        agreement[method] = float((got == want).all(axis=1).mean())
    print(f"bf16 transformer ({arm}) clip agreement with JAX bf16 on 64 clips: {agreement}")
    assert agreement["greedy"] >= MIN_GREEDY_AGREEMENT


def test_bf16_transformer_trainer_validation_matches_jax(tmp_path):
    """``training.compute_dtype="bfloat16"``: the port's validation decode
    (a bfloat16 copy of the weights, bfloat16 features) against the JAX
    trainer's ``gen_step`` (every float32 leaf cast, features cast, greedy
    over max_sequence_length) on 64 sharpened clips: greedy agreement
    >= 0.9."""
    cfg = _tr_config()
    cfg.training.compute_dtype = "bfloat16"
    V = 20
    params = jax.tree_util.tree_map(np.array, j_cap.init_model(jax.random.PRNGKey(3), cfg, V))
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * 3.0
    pcfg = _port(cfg)
    pcfg.experiment.checkpoint_dir = Path(tmp_path)
    pcfg.experiment.use_tensorboard = False
    vocab = Vocabulary(pcfg)
    out["bias"][vocab.end_idx] = -1e9
    for i in range(len(vocab), V):
        vocab.word2idx[f"w{i}"] = i
        vocab.idx2word[i] = f"w{i}"
    rs = np.random.RandomState(8)
    T = cfg.model.max_sequence_length
    batch = {"video_features": rs.randn(64, 10, 24).astype(np.float32),
             "input_tokens": rs.randint(0, V, (64, T)).astype(np.int32),
             "target_tokens": rs.randint(1, V, (64, T)).astype(np.int32)}

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, tree)

    cp = cast(params)
    enc, final, mask = j_cap.encode(cp, cfg, jnp.asarray(batch["video_features"])
                                    .astype(jnp.bfloat16))
    want = np.asarray(j_greedy(cp, cfg, enc, final, vocab.start_idx, vocab.end_idx, T,
                               mask)["generated_tokens"])
    model = VideoCaptioningModel(pcfg, V)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    trainer = VideoCaptioningTrainer(model, pcfg, vocab, None, [batch], device="cpu")
    seen = []
    with mock.patch.object(t_trainer, "greedy_generate",
                           _recorder(t_trainer.greedy_generate, seen)):
        metrics = trainer.validate_epoch()
    assert trainer._eval_model.decoder.output_projection.weight.dtype == torch.bfloat16
    got = np.concatenate(seen)
    agreement = float((got == want).all(axis=1).mean())
    print(f"bf16 transformer trainer validation: greedy agreement with JAX's gen_step on 64 "
          f"clips {agreement}; metrics {metrics}")
    assert agreement >= MIN_GREEDY_AGREEMENT


def _recorder(fn, seen):
    def recording(model, config, enc, *args, **kwargs):
        assert enc.dtype == torch.bfloat16  # bfloat16 features through bfloat16 weights
        out = fn(model, config, enc, *args, **kwargs)
        seen.append(out["generated_tokens"].numpy())
        return out
    return recording
