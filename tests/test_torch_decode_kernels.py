"""The fused decode-step configuration of the port on the CPU: each new
kernel module's plain version against the JAX Pallas kernel it stands for
(run in interpret mode, as tests/test_pallas_kernels.py runs them), and
greedy, beam and eval-mode teacher forcing with the kernel flags on
against the JAX package with the same flags. The CUDA kernels themselves
are held against these plain versions on the card by chip_smoke.py."""

import unittest.mock as mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import video_captioning_tpu.generation.beam as j_beam
from video_captioning_tpu import generation as j_gen
from video_captioning_tpu.models import captioner as j_cap
from video_captioning_tpu.models import init_model
from video_captioning_tpu.ops import vocab_topk_pallas as j_vtp
from video_captioning_tpu.ops.attention_pallas import bahdanau_attend_pallas
from video_captioning_tpu.ops.lstm_pallas import lstm_cell_pallas
from video_captioning_tpu.ops.topk_pallas import topk2d_pallas
from video_captioning_tpu_torch import generation as t_gen
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.generation import beam as t_beam
from video_captioning_tpu_torch.models.captioner import VideoCaptioningModel, apply_model
from video_captioning_tpu_torch.models.weights import state_dict_from_jax_params
from video_captioning_tpu_torch.ops import launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.attention import bahdanau_attend, bahdanau_attend_reference
from video_captioning_tpu_torch.ops.lstm_cell import lstm_cell_fused, lstm_cell_reference
from video_captioning_tpu_torch.ops.topk import topk2d, topk2d_reference
from video_captioning_tpu_torch.ops.vocab_topk import (
    MAX_SMEM,
    TILE_COLS,
    pad_vocab_weights,
    vocab_partition,
    vocab_smem_bytes,
    vocab_topk_lse,
    vocab_topk_lse_reference,
)

VOCAB = 29


def port(cfg) -> PortConfig:
    """The port's own Config, built from the JAX config's dict."""
    return PortConfig.from_dict(cfg.to_dict())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


# --------------------------------------------------------------- kernels


def _attend_inputs(B, S=10, D=16, A=12, E=20, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, D).astype(np.float32)
    w_d = (rs.randn(D, A) * 0.3).astype(np.float32)  # JAX layout (D, A)
    b_d = (rs.randn(A) * 0.1).astype(np.float32)
    enc_outs = rs.randn(B, S, E).astype(np.float32)
    enc_proj = (enc_outs @ (rs.randn(E, A) * 0.3)).astype(np.float32)
    v = (rs.randn(A) * 0.3).astype(np.float32)
    b_v = np.float32(0.05)
    return h, w_d, b_d, enc_proj, enc_outs, v, b_v


@pytest.mark.parametrize("mask_kind", ["ragged", "none"])
@pytest.mark.parametrize("B", [1, 5, 13])
def test_bahdanau_attend_reference_matches_pallas(B, mask_kind):
    """B = 5 and 13 take the JAX wrapper's block_b = 8 padding; the ragged
    mask holds one all-masked row, which must get uniform weights."""
    h, w_d, b_d, enc_proj, enc_outs, v, b_v = _attend_inputs(B, seed=B)
    S = enc_proj.shape[1]
    mask = None
    if mask_kind == "ragged":
        rs = np.random.RandomState(100 + B)
        lengths = rs.randint(1, S + 1, size=B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
        mask[-1] = 0.0
    want_ctx, want_w = bahdanau_attend_pallas(
        jnp.asarray(h), jnp.asarray(w_d), jnp.asarray(b_d), jnp.asarray(enc_proj),
        jnp.asarray(enc_outs), jnp.asarray(v), jnp.asarray(b_v),
        None if mask is None else jnp.asarray(mask), interpret=True)
    args = (t(h), t(w_d.T), t(b_d), t(enc_proj), t(enc_outs), t(v), t(np.array([b_v])),
            None if mask is None else t(mask))
    got_ctx, got_w = bahdanau_attend_reference(*args)
    # The JAX kernel test's own tolerance (test_pallas_kernels.py:45): both
    # sides run float32 with sums in different orders.
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-5)
    if mask is not None:
        np.testing.assert_allclose(got_w[-1].numpy(), np.full(S, 1.0 / S), rtol=1e-6)
    # On the CPU the wrapper is the plain version, launch-free.
    reset_launch_counts()
    for a, b in zip(bahdanau_attend(*args), (got_ctx, got_w)):
        assert torch.equal(a, b)
    assert launch_counts()["bahdanau_attend"] == 0


def _lstm_layer(In, H, seed):
    rs = np.random.RandomState(seed)
    return {
        "w_ih": (rs.randn(In, 4 * H) * 0.3).astype(np.float32),  # JAX layout (In, 4H)
        "w_hh": (rs.randn(H, 4 * H) * 0.3).astype(np.float32),
        "b_ih": (rs.randn(4 * H) * 0.1).astype(np.float32),
        "b_hh": (rs.randn(4 * H) * 0.1).astype(np.float32),
    }


@pytest.mark.parametrize("N, In, H", [(3, 28, 16), (8, 28, 16), (37, 13, 40)],
                         ids=["3", "8", "37-13-40"])
def test_lstm_cell_reference_matches_pallas(N, In, H):
    """In = 28 != H = 16; block_b = 5 pads N = 8 in the JAX wrapper. 37-13-40
    is an odd shape the card's kernel takes on its 4-byte copy path: N not
    a multiple of any tile's rows, In not a multiple of 4, H = 40."""
    layer = _lstm_layer(In, H, seed=N)
    rs = np.random.RandomState(50 + N)
    x, h, c = (rs.randn(N, d).astype(np.float32) for d in (In, H, H))
    want_h, want_c = lstm_cell_pallas({k: jnp.asarray(a) for k, a in layer.items()},
                                      jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                                      block_b=5, interpret=True)
    t_layer = {k: t(a.T) if a.ndim == 2 else t(a) for k, a in layer.items()}  # (4H, in)
    got_h, got_c = lstm_cell_reference(t_layer, t(x), t(h), t(c))
    # float32 on both sides, sums in different orders (the JAX test's 1e-5).
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)
    got = lstm_cell_fused(t_layer, t(x), t(h), t(c))
    assert torch.equal(got[0], got_h) and torch.equal(got[1], got_c)


# The card's lstm_cell kernel and its tolerance (chip_smoke.LSTM_CELL_ATOL).
LSTM_CELL_ATOL = 2e-5


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, as cvt.rna.tf32.f32 does: on the bit pattern, add half
    of the dropped 13 bits' weight to the magnitude and clear them."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (M, K) . b (N, K)^T as the kernels take it on the tensor cores:
    each operand split into hi = rna(v) and lo = rna(v - hi), the products
    hi.hi + hi.lo + lo.hi (lo.lo dropped) summed in float32."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    t = [torch.from_numpy(v) for v in (ah, al, bh, bl)]
    return ((t[1] @ t[2].T + t[0] @ t[3].T) + t[0] @ t[2].T).numpy()


def test_tf32_rounding_keeps_ten_mantissa_bits_and_rounds_ties_away():
    one_ulp = np.float32(2.0 ** -10)
    vals = np.array([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                     3.0 + 2.0 ** -20], np.float32)
    want = np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(vals), want)
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi = tf32_rna(x)
    assert (hi.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    # hi + lo carries v to about 2^-22 of |v|.
    lo = tf32_rna(x - hi)
    assert (np.abs((hi.astype(np.float64) + lo) - x) <= np.abs(x) * 2.0 ** -21).all()


def test_lstm_cell_3xtf32_products_stay_within_a_quarter_of_the_card_tolerance():
    """The beam step's layer-0 cell (N = 640, In = 1024, H = 512) with the
    recipe of chip_smoke.lstm_cell_inputs (weights uniform in +-1/sqrt(H),
    x ~ N(0, 1), h = tanh(N(0, 1)), c ~ N(0, 1)): gates from the 3xTF32
    split, summed in float32, against float64 gates; h' and c' within
    LSTM_CELL_ATOL / 4, so the card's tolerance has room for the kernel's
    summation order."""
    N, In, H = 640, 1024, 512
    rs = np.random.RandomState(7)
    r = 1.0 / H ** 0.5
    w = ((rs.rand(4 * H, In + H) * 2 - 1) * r).astype(np.float32)  # [W_ih | W_hh]
    b = ((rs.rand(2, 4 * H) * 2 - 1) * r).astype(np.float32)
    a = np.concatenate([rs.randn(N, In), np.tanh(rs.randn(N, H))], 1).astype(np.float32)
    c = rs.randn(N, H).astype(np.float32)

    def cell(gates):
        i, f, g, o = np.split(gates.astype(np.float64) + b[0] + b[1], 4, axis=1)
        sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
        c_new = sig(f) * c + sig(i) * np.tanh(g)
        return sig(o) * np.tanh(c_new), c_new

    got = cell(matmul_3xtf32(a, w))
    want = cell(a.astype(np.float64) @ w.astype(np.float64).T)
    err = max(np.abs(x - y).max() for x, y in zip(got, want))
    assert err <= LSTM_CELL_ATOL / 4, err
    # The split is what keeps it there: one TF32 product is far outside.
    one = cell((torch.from_numpy(tf32_rna(a)) @ torch.from_numpy(tf32_rna(w)).T).numpy())
    assert max(np.abs(x - y).max() for x, y in zip(one, want)) > LSTM_CELL_ATOL


def _vocab_check(x, W, b, k, vt=128):
    wp_j, bp_j, vp_j = j_vtp.pad_vocab_weights(jnp.asarray(W), jnp.asarray(b), vt=vt)
    want = j_vtp.vocab_topk_lse(jnp.asarray(x), wp_j, bp_j, k, vt=vt, interpret=True)
    wp, bp, vp = pad_vocab_weights(t(W), t(b), vt=vt)
    assert vp == vp_j
    assert torch.equal(wp.float(), t(wp_j.astype(jnp.float32)))
    assert torch.equal(bp, t(bp_j))
    got = vocab_topk_lse_reference(t(x), wp, bp, k)
    assert got[1].dtype == torch.int32
    # Values: bf16 products are exact, float32 sums in different orders
    # (the JAX kernel test's 1e-6, test_pallas_kernels.py:233); indices
    # exact; lse to float32 rounding of an online sum (its 1e-5, :235-237).
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)
    for a, b_ in zip(vocab_topk_lse(t(x), wp, bp, k), got):
        assert torch.equal(a, b_)
    return got


def _vocab_random_check(N, H, V, k):
    rs = np.random.RandomState(k)
    x = rs.randn(N, H).astype(np.float32)
    W = (rs.randn(H, V) * 0.1).astype(np.float32)
    b = (rs.randn(V) * 0.1).astype(np.float32)
    _vocab_check(x, W, b, k)


@pytest.mark.parametrize("k", [1, 5])
def test_vocab_topk_lse_reference_matches_pallas(k):
    """V = 700 pads to 768 at vt = 128; N = 20 rows."""
    _vocab_random_check(20, 32, 700, k)


@pytest.mark.parametrize("k", [1, 16])
def test_vocab_topk_lse_reference_matches_pallas_at_the_kernels_odd_shape(k):
    """A ragged row block (N = 37) and H = 200 (not a multiple of the
    kernel's k-chunk)."""
    _vocab_random_check(37, 200, 1000, k)


def test_vocab_topk_lse_cross_block_ties_and_bf16_rounding():
    """Exact ties across 128-column blocks keep ascending vocabulary order,
    and x is rounded to nearest even: 1 + 3 * 2^-8 lies halfway between two
    bf16 values and rounds up (truncation would round down)."""
    N, H, V = 20, 32, 700
    x = np.zeros((N, H), np.float32)
    x[:, 0] = 1.0
    W = np.zeros((H, V), np.float32)
    W[0, [3, 130, 131, 500, 699]] = 2.0
    got = _vocab_check(x, W, np.zeros(V, np.float32), 5)
    np.testing.assert_array_equal(got[1][0].numpy(), [3, 130, 131, 500, 699])
    x[:, 0] = 1.0 + 3 * 2.0 ** -8
    W[0, 7] = 4.0
    got = _vocab_check(x, W, np.zeros(V, np.float32), 1)
    assert got[0][0, 0].item() == 4.0 * (1.0 + 2.0 ** -6)


# (N, H, Vp, SMs): the beam step's shape, one row, H = 200, the most rows
# the beam step sends, a wide H, Vp = 136, a card with few SMs.
PARTITION_CASES = [(640, 512, 10112, 132), (1, 512, 10112, 132), (37, 200, 10112, 132),
                   (2560, 512, 10112, 132), (640, 1024, 10112, 132), (37, 512, 136, 132),
                   (640, 512, 10112, 7)]


@pytest.mark.parametrize("N,H,Vp,n_sm", PARTITION_CASES)
def test_vocab_partition_spans_cover_every_tile_once(N, H, Vp, n_sm):
    p = vocab_partition(N, H, Vp, n_sm)
    assert p["tiles"] == -(-Vp // TILE_COLS)
    spans = [range(s * p["tiles_per_span"], min((s + 1) * p["tiles_per_span"], p["tiles"]))
             for s in range(p["spans"])]
    assert all(len(r) > 0 for r in spans)
    assert sorted(t for r in spans for t in r) == list(range(p["tiles"]))
    assert (p["row_blocks"] - 1) * p["rows"] < N <= p["row_blocks"] * p["rows"]
    # One wave where the row blocks alone do not exceed the SMs.
    assert p["row_blocks"] * p["spans"] <= max(n_sm, p["row_blocks"])
    assert p["h_pad"] % 64 == 0 and H <= p["h_pad"] < H + 64
    assert vocab_smem_bytes(p["rows"], p["h_pad"]) <= MAX_SMEM


def test_vocab_partition_row_blocks_and_shared_memory():
    """128-row blocks up to H = 512, 64-row ones up to H = 1152, none past
    that; shared memory as the kernel lays it out (2 KB of barriers and bias,
    4 ring stages of 64 x 128 bf16, x rows of Hp bf16, 32 floats for each of
    the 2 rows product threads)."""
    assert vocab_smem_bytes(128, 512) == 2048 + 4 * 16384 + 128 * 512 * 2 + 256 * 32 * 4
    assert vocab_smem_bytes(64, 1152) == 2048 + 4 * 16384 + 64 * 1152 * 2 + 128 * 32 * 4 <= MAX_SMEM
    assert [vocab_partition(640, h, 10112, 132)["rows"] for h in (512, 513, 1152)] == [128, 64, 64]
    p = vocab_partition(640, 512, 10112, 132)
    assert (p["row_blocks"], p["spans"], p["tiles_per_span"], p["h_pad"]) == (5, 20, 4, 512)
    assert vocab_partition(37, 200, 136, 132)["h_pad"] == 256
    with pytest.raises(ValueError, match="no room"):
        vocab_partition(640, 1153, 10112, 132)


def _topk_inputs(N=64, V=300, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(N, V) * 3).astype(np.float32)
    x[5, [7, V // 3, V - 1]] = 9.5     # tie at the top
    x[6, :] = 1.25                      # whole row tied
    x[7, 40:60] = x[7].max()            # run of ties
    x[8, V // 2:] = -np.inf             # -inf tail
    return x


def _check_topk2d_against_pallas(x, k):
    want_v, want_i = topk2d_pallas(jnp.asarray(x), k, interpret=True)
    got_v, got_i = topk2d_reference(t(x), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for a, b in zip(topk2d(t(x), k), (got_v, got_i)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk2d_reference_matches_pallas(k):
    _check_topk2d_against_pallas(_topk_inputs(seed=k), k)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk2d_reference_matches_pallas_at_the_kernels_odd_shape(k):
    """A row of V % 4 != 0 and a ragged row count."""
    _check_topk2d_against_pallas(_topk_inputs(37, 10001, seed=k), k)


def test_new_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.empty(4, 20, device="meta")
    with pytest.raises(ValueError):
        topk2d(meta, 3)  # neither CPU nor CUDA: no plain-version fallback
    with pytest.raises(ValueError):
        topk2d(torch.zeros(4, 20), 17)
    layer = {"w_ih": torch.zeros(64, 12), "w_hh": torch.zeros(64, 16),
             "b_ih": torch.zeros(64), "b_hh": torch.zeros(64)}
    x, h = torch.zeros(3, 12), torch.zeros(3, 16)
    with pytest.raises(ValueError):
        lstm_cell_fused(layer, x, h, torch.zeros(3, 8))
    with pytest.raises(ValueError):
        lstm_cell_fused({**layer, "w_ih": torch.zeros(12, 64)}, x, h, h)  # not (4H, In)
    # Other dtypes are cast to float32, as the JAX wrapper casts every operand.
    assert all(t.dtype == torch.float32 for t in lstm_cell_fused(layer, x.double(), h, h))
    args = [torch.zeros(2, 16), torch.zeros(8, 16), torch.zeros(8), torch.zeros(2, 5, 8),
            torch.zeros(2, 5, 6), torch.zeros(8), torch.zeros(1), None]
    with pytest.raises(ValueError):
        bahdanau_attend(*args[:-2], torch.zeros(()), None)  # b_v must be (1,)
    # A bool mask is cast to float32, as the JAX wrapper casts it.
    assert bahdanau_attend(*args[:-1], torch.ones(2, 5, dtype=torch.bool))[1].dtype == torch.float32
    with pytest.raises(ValueError):
        bahdanau_attend(args[0], args[1].T, *args[2:])  # W_d (D, A), not (A, D)
    w, b, _ = pad_vocab_weights(torch.zeros(16, 30), torch.zeros(30))
    with pytest.raises(ValueError):
        vocab_topk_lse(torch.zeros(3, 16), w.float(), b, 4)  # weights not bf16
    with pytest.raises(ValueError):
        vocab_topk_lse(torch.zeros(3, 8), w, b, 4)  # H mismatch
    with pytest.raises(ValueError):
        vocab_topk_lse(torch.zeros(3, 16), w, b, 17)
    with pytest.raises(ValueError):
        pad_vocab_weights(torch.zeros(16, 30), torch.zeros(30), vt=12)


# ------------------------------------------------------------- the slice


def _pair(cfg, seed, sharpen=3.0):
    """Same weights on both sides, the vocabulary projection sharpened as in
    tests/test_torch_generation.py (trained-model logit margins)."""
    params = init_model(jax.random.PRNGKey(seed), cfg, VOCAB)
    out = params["decoder"]["output_projection"]
    out["kernel"] = out["kernel"] * sharpen
    pcfg = port(cfg)
    model = VideoCaptioningModel(pcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax_params(params, pcfg))
    return params, model.eval()


def _inputs(cfg, seed, B=5, ragged=True):
    rs = np.random.RandomState(seed)
    T = cfg.model.video_sequence_length
    feats = rs.randn(B, T, cfg.model.cnn_feature_dim).astype(np.float32)
    if not ragged:
        return feats, None
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    return feats, (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_with_attention_and_cell_kernels_matches_jax(tiny_config, seed, ragged):
    cfg = tiny_config
    cfg.kernels.use_pallas_attention = True
    cfg.kernels.use_pallas_lstm = True
    cfg.kernels.interpret = True
    params, model = _pair(cfg, seed)
    feats, mask = _inputs(cfg, seed, ragged=ragged)
    jmask = None if mask is None else jnp.asarray(mask)
    want = j_gen.generate(params, cfg, jnp.asarray(feats), 1, 2, 8, jmask, method="greedy")
    with torch.no_grad():
        got = t_gen.generate(model, port(cfg), t(feats), 1, 2, 8,
                             None if mask is None else t(mask), method="greedy")
    np.testing.assert_array_equal(got["generated_tokens"].numpy(),
                                  np.asarray(want["generated_tokens"]))
    # float32 on both sides; sum orders differ (tests/test_torch_model.py's 2e-5).
    np.testing.assert_allclose(got["attention_weights"].numpy(),
                               np.asarray(want["attention_weights"]), rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_with_cell_and_fused_vocab_kernels_matches_jax(tiny_config, seed):
    """Both packages forced onto the fused vocabulary path on the CPU: the
    JAX one as tests/test_pallas_kernels.py:283-290 does, the port by
    patching ``fused_vocab_eligible``. The same encoder outputs feed both
    decoders, so their pre-vocab states agree to float32 rounding before
    the bf16 rounding of the fused projection."""
    cfg = tiny_config
    cfg.kernels.use_pallas_lstm = True
    cfg.kernels.use_fused_vocab_topk = True
    cfg.kernels.interpret = True
    params, model = _pair(cfg, seed)
    feats, mask = _inputs(cfg, seed, ragged=seed != 2)
    jmask = None if mask is None else jnp.asarray(mask)
    enc, final, jmask = j_cap.encode(params, cfg, jnp.asarray(feats), jmask)
    orig = j_vtp.vocab_topk_lse
    with mock.patch.object(jax, "default_backend", return_value="tpu"), \
         mock.patch.object(j_vtp, "vocab_topk_lse",
                           lambda *a, **kw: orig(*a, **{**kw, "interpret": True})):
        want = j_beam.beam_search_generate(params, cfg, enc, final, 1, 2, 8, jmask,
                                           beam_size=4)
    reset_launch_counts()
    topk_calls = []
    real_topk2d_lse = t_beam.topk2d_lse
    with mock.patch.object(t_beam, "fused_vocab_eligible", return_value=True), \
         mock.patch.object(t_beam, "topk2d_lse",
                           lambda *a: topk_calls.append(1) or real_topk2d_lse(*a)), \
         torch.no_grad():
        got = t_beam.beam_search_generate(
            model, port(cfg), t(np.asarray(enc)), t(np.asarray(final)), 1, 2, 8,
            t(np.asarray(jmask)), beam_size=4)
    assert not topk_calls  # the fused branch replaces topk2d_lse, as in JAX
    for key in ("generated_tokens", "all_tokens"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    # -1e9 padding compares exactly; scores to float32 rounding
    # (tests/test_torch_generation.py's 1e-4).
    np.testing.assert_allclose(got["all_scores"].numpy(), np.asarray(want["all_scores"]),
                               rtol=0, atol=1e-4)
    assert sum(launch_counts().values()) == 0


def test_fused_vocab_gate_follows_the_jax_conditions(tiny_config):
    cfg = port(tiny_config)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not t_beam.fused_vocab_eligible(cfg, cuda, 4, 5, 29)  # flag off
    cfg.kernels.use_fused_vocab_topk = True
    assert t_beam.fused_vocab_eligible(cfg, cuda, 4, 5, 29)
    assert t_beam.fused_vocab_eligible(cfg, cuda, 512, 5, 29)      # B*K = 2560
    assert not t_beam.fused_vocab_eligible(cfg, cuda, 513, 5, 29)
    assert not t_beam.fused_vocab_eligible(cfg, cuda, 4, 17, 29)   # min(K, V) > 16
    assert t_beam.fused_vocab_eligible(cfg, cuda, 4, 17, 16)
    assert not t_beam.fused_vocab_eligible(cfg, cpu, 4, 5, 29)    # off the card


def test_beam_with_fused_flag_on_cpu_keeps_the_hierarchical_path(tiny_config):
    """Unforced, the gate is false on the CPU: with the flag on, tokens and
    scores are exactly the flag-off run's, as in the JAX package off the
    TPU."""
    cfg = tiny_config
    params, model = _pair(cfg, 3)
    feats, mask = _inputs(cfg, 3)
    with torch.no_grad():
        ref = t_gen.generate(model, port(cfg), t(feats), 1, 2, 8, t(mask), method="beam",
                             beam_size=4)
        cfg.kernels.use_fused_vocab_topk = True
        got = t_gen.generate(model, port(cfg), t(feats), 1, 2, 8, t(mask), method="beam",
                             beam_size=4)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key


@pytest.mark.parametrize("flags", [("use_pallas_attention",),
                                   ("use_pallas_attention", "use_pallas_lstm")])
def test_eval_teacher_forcing_with_attention_kernel_matches_jax(tiny_config, flags):
    cfg = tiny_config
    for flag in flags:
        setattr(cfg.kernels, flag, True)
    cfg.kernels.interpret = True
    params, model = _pair(cfg, 4)
    feats, mask = _inputs(cfg, 4)
    tokens = np.random.RandomState(4).randint(0, VOCAB, (5, 7)).astype(np.int32)
    want = j_cap.apply_model(params, cfg, jnp.asarray(feats), jnp.asarray(tokens),
                             jnp.asarray(mask), train=False)
    with torch.no_grad():
        got = apply_model(model, port(cfg), t(feats), t(tokens).long(), t(mask), train=False)
    # float32 on both sides (tests/test_torch_model.py's 2e-5).
    for key in ("logits", "attention_weights"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=2e-5,
                                   err_msg=key)
