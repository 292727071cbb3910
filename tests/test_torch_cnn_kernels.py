"""The CNN backbones' kernels in the port: each plain version against the
JAX package's Pallas kernel run in interpret mode, on the same
numpy-seeded inputs (the port's weights in torch's (out, in) layout, the
JAX ones in theirs). The CUDA kernels are held against these plain
versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_captioning_tpu.ops.bottleneck_pallas import fused_bottleneck as jax_fused_bottleneck
from video_captioning_tpu.ops.conv1x1_pallas import conv1x1 as jax_conv1x1
from video_captioning_tpu.ops.conv1x1_pallas import matmul_bias_act as jax_matmul_bias_act
from video_captioning_tpu.ops.int8_matmul_pallas import (
    int8_matmul_requant as jax_int8_requant,
)
from video_captioning_tpu.ops.int8_matmul_pallas import (
    int8_matmul_residual_requant as jax_int8_residual,
)
from video_captioning_tpu_torch.ops.bottleneck import fused_bottleneck, fused_bottleneck_reference
from video_captioning_tpu_torch.ops.conv1x1 import (
    conv1x1,
    matmul_bias_act,
    matmul_bias_act_reference,
)
from video_captioning_tpu_torch.ops.int8_matmul import (
    int8_matmul_requant,
    int8_matmul_requant_reference,
    int8_matmul_residual_requant,
    int8_matmul_residual_requant_reference,
    pad_k16,
)

# int8 outputs: XLA fuses an FMA into the JAX epilogue where the port rounds
# the product and the sum apart, so a value at a .5 requant boundary can
# land one int8 step away; at most this share of entries may.
INT8_OFF_BY_ONE_SHARE = 1e-3


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _bottleneck_case(B, H, W, C, Cm, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, W, C).astype(np.float32)
    w1 = (rs.randn(C, Cm) * 0.1).astype(np.float32)
    b1 = rs.randn(Cm).astype(np.float32)
    w2 = (rs.randn(3, 3, Cm, Cm) * 0.05).astype(np.float32)  # HWIO
    b2 = rs.randn(Cm).astype(np.float32)
    w3 = (rs.randn(Cm, C) * 0.1).astype(np.float32)
    b3 = rs.randn(C).astype(np.float32)
    return x, (w1, b1, w2, b2, w3, b3)


def _port_weights(ws, dtype):
    w1, b1, w2, b2, w3, b3 = ws
    w2 = _t(w2.transpose(3, 2, 0, 1), dtype).contiguous(memory_format=torch.channels_last)
    return (_t(w1.T, dtype), _t(b1, dtype), w2, _t(b2, dtype), _t(w3.T, dtype), _t(b3, dtype))


@pytest.mark.parametrize("shape", [(2, 14, 14, 256, 64), (2, 7, 7, 1024, 256),
                                   (3, 7, 7, 256, 64), (5, 14, 14, 128, 32)],
                         ids=["stage1_like", "stage4_like", "odd_batch_7x7", "odd_batch_14x14"])
def test_fused_bottleneck_plain_version_matches_pallas(shape):
    B, H, W, C, Cm = shape
    x, ws = _bottleneck_case(B, H, W, C, Cm, seed=1)
    want = np.asarray(jax_fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, ws),
                                           interpret=True))
    got = fused_bottleneck(_t(x), *_port_weights(ws, torch.float32))
    # float32 sums of up to 9 * Cm products in different orders: within 1e-5
    # of the output's scale.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # y1 outside the image is zero after the ReLU, not relu(b1): b1 is large
    # and positive at the border here, so a relu(b1) halo would show.
    assert (np.abs(want[:, 0]) > 0).any()


def test_fused_bottleneck_bf16_within_one_ulp_of_the_output_scale():
    x, ws = _bottleneck_case(2, 14, 14, 256, 64, seed=2)
    bf = jnp.bfloat16
    want = np.asarray(jax_fused_bottleneck(jnp.asarray(x, bf),
                                           *(jnp.asarray(w, bf) for w in ws),
                                           interpret=True).astype(jnp.float32))
    got = fused_bottleneck(_t(x, torch.bfloat16), *_port_weights(ws, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # Both round y1 and y2 to bf16 from float32 sums taken in different
    # orders; one bf16 ulp (2^-8 relative) of the largest output.
    ulp = np.abs(want).max() * 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_fused_bottleneck_wrapper_checks_and_cpu_dispatch():
    x, ws = _bottleneck_case(1, 4, 5, 16, 4, seed=3)
    pw = _port_weights(ws, torch.float32)
    assert torch.equal(fused_bottleneck(_t(x), *pw), fused_bottleneck_reference(_t(x), *pw))
    assert fused_bottleneck.launches == 0
    with pytest.raises(ValueError, match="channels_last"):
        fused_bottleneck(_t(x), pw[0], pw[1], pw[2].contiguous(), *pw[3:])
    with pytest.raises(ValueError):
        fused_bottleneck(_t(x).double(), *pw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_bottleneck(torch.empty((1, 4, 5, 16), device="meta"),
                         *(w.to("meta") for w in pw))


# The card's fused_bottleneck tolerance in float32 (chip_smoke.CNN_RTOL).
CNN_RTOL_F32 = 1e-5


def _tf32_rna(a):
    """float32 rounded to TF32 to nearest, ties away (cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a (M, K) . b (N, K)^T by the 3xTF32 split of csrc/tf32x3.cuh:
    hi.hi + hi.lo + lo.hi, summed in float32."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    t = [torch.from_numpy(v) for v in (ah, al, bh, bl)]
    return ((t[1] @ t[2].T + t[0] @ t[3].T) + t[0] @ t[2].T).numpy()


def test_fused_bottleneck_3xtf32_chain_stays_within_a_quarter_of_the_card_tolerance():
    """A stage-4 block at full width on one image (7 x 7, C = 2048,
    Cm = 512), with chip_smoke.bottleneck_inputs' scales (post-ReLU x,
    He-normal folded weights, w3 at 0.2 of He): the three products chained
    through the 3xTF32 split against a float64 chain, within
    CNN_RTOL_F32 / 4 of the largest output."""
    H = W = 7
    C, Cm = 2048, 512
    rs = np.random.RandomState(44)

    def he(*shape, fan_in):
        return (rs.randn(*shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)

    x = np.abs(rs.randn(H * W, C)).astype(np.float32)
    w1, b1 = he(Cm, C, fan_in=C), (rs.randn(Cm) * 0.1).astype(np.float32)
    w2, b2 = he(Cm, 3, 3, Cm, fan_in=9 * Cm), (rs.randn(Cm) * 0.1).astype(np.float32)
    w3, b3 = he(C, Cm, fan_in=Cm) * np.float32(0.2), (rs.randn(C) * 0.1).astype(np.float32)

    def block(mm, dt):
        y1 = np.maximum(mm(x.astype(dt), w1.astype(dt)) + b1, 0).astype(dt)
        pad = np.zeros((H + 2, W + 2, Cm), dt)
        pad[1:-1, 1:-1] = y1.reshape(H, W, Cm)
        cols = np.stack([pad[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
                        axis=2).reshape(H * W, 9 * Cm)  # k = tap * Cm + ci, w2's row order
        y2 = np.maximum(mm(cols, w2.reshape(Cm, 9 * Cm).astype(dt)) + b2, 0).astype(dt)
        return np.maximum(mm(y2, w3.astype(dt)) + b3 + x, 0)

    got = block(_mm_3xtf32, np.float32)
    want = block(lambda a, b: a @ b.T, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= CNN_RTOL_F32 / 4, err


@pytest.mark.parametrize("epilogue", ["residual_relu", "relu", "residual_no_relu"])
def test_matmul_bias_act_plain_version_matches_pallas(epilogue):
    rs = np.random.RandomState(4)
    x, w, b, r = (rs.randn(*s).astype(np.float32) for s in ((448, 96), (96, 64), (64,),
                                                             (448, 64)))
    residual = None if epilogue == "relu" else r
    relu = epilogue != "residual_no_relu"
    want = np.asarray(jax_matmul_bias_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if residual is None else jnp.asarray(residual), relu=relu, interpret=True))
    got = matmul_bias_act(_t(x), _t(w.T), _t(b), None if residual is None else _t(residual),
                          relu=relu)
    if not relu:
        assert want.min() < 0  # relu=False with a residual is honoured
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, matmul_bias_act_reference(
        _t(x), _t(w.T), _t(b), None if residual is None else _t(residual), relu=relu))


# Shapes at the edges of the card kernel's tiling (csrc/conv1x1.cu: 32-row
# blocks, 256-column blocks of 8 warps x 32, k-tiles of 32 float32 / 64
# bf16 values) that the JAX block rule also takes (M and N multiples of
# 16): M not a multiple of 32, K not a multiple of 16, N not a multiple of
# 64, and N past one column block with K over three float32 k-tiles.
MBA_EDGE_SHAPES = [(1008, 40, 208), (336, 24, 80), (176, 100, 272)]


@pytest.mark.parametrize("epilogue", ["residual_relu", "relu", "residual_no_relu"])
@pytest.mark.parametrize("shape", MBA_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_bias_act_plain_version_matches_pallas_at_tiling_edges(shape, epilogue):
    M, K, N = shape
    rs = np.random.RandomState(M + K + N)
    x, w, b, r = (rs.randn(*s).astype(np.float32) for s in ((M, K), (K, N), (N,), (M, N)))
    residual = None if epilogue == "relu" else r
    relu = epilogue != "residual_no_relu"
    want = np.asarray(jax_matmul_bias_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if residual is None else jnp.asarray(residual), relu=relu, interpret=True))
    got = matmul_bias_act(_t(x), _t(w.T), _t(b), None if residual is None else _t(residual),
                          relu=relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4096, 64, 256), (2048, 256, 512)],
                         ids=["stage1_conv3", "stage2_downsample"])
def test_matmul_bias_act_3xtf32_stays_within_a_quarter_of_the_card_tolerance(shape):
    """The card kernel's float32 products by the 3xTF32 split (hi.hi + hi.lo
    + lo.hi) at chip_smoke.check_conv1x1's shapes and scales (w at
    1 / sqrt(K), bias 0.1, a unit residual) against float64, with the
    residual and ReLU: within CNN_RTOL_F32 / 4 of the largest output."""
    M, K, N = shape
    rs = np.random.RandomState(9)
    x = rs.randn(M, K).astype(np.float32)
    w = (rs.randn(N, K) / np.sqrt(K)).astype(np.float32)
    b = (rs.randn(N) * 0.1).astype(np.float32)
    r = rs.randn(M, N).astype(np.float32)
    got = np.maximum(_mm_3xtf32(x, w) + b + r, 0)
    want = np.maximum(x.astype(np.float64) @ w.T.astype(np.float64) + b + r, 0)
    assert np.abs(got - want).max() / np.abs(want).max() <= CNN_RTOL_F32 / 4


def test_conv1x1_stride2_plain_version_matches_pallas():
    rs = np.random.RandomState(5)
    x, w, b = (rs.randn(*s).astype(np.float32) for s in ((1, 56, 56, 32), (32, 64), (64,)))
    want = np.asarray(jax_conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2,
                                  relu=False, interpret=True))
    got = conv1x1(_t(x), _t(w.T), _t(b), stride=2, relu=False)
    assert got.shape == (1, 28, 28, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # Shapes the TPU block rule refuses (M = 49) run here.
    small = conv1x1(_t(x[:, :7, :7]), _t(w.T), _t(b))
    assert small.shape == (1, 7, 7, 64)


def _int8_case(M, K, N, seed):
    rs = np.random.RandomState(seed)
    xq = rs.randint(0, 128, (M, K)).astype(np.int8)
    wq = rs.randint(-127, 128, (K, N)).astype(np.int8)
    scale = (rs.rand(N) * 4.0 / (64 * 73 * np.sqrt(K))).astype(np.float32)
    bias = (rs.randn(N) * 0.5).astype(np.float32)
    idq = rs.randint(-127, 128, (M, N)).astype(np.int8)
    return xq, wq, scale, bias, idq


def _compare_int8(got: torch.Tensor, want: np.ndarray) -> None:
    if want.dtype == np.int8:
        assert got.dtype == torch.int8
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= INT8_OFF_BY_ONE_SHARE, (diff > 0).mean()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# (256, 64, 48) keeps its original IDs; the others are shapes of the
# ResNet50 ladder at small M, and K = 13 (the kernel's padded path).
INT8_CASES = [pytest.param(s_out, shape, id=tag + suffix)
              for shape, suffix in (((256, 64, 48), ""), ((200, 512, 128), "-200x512x128"),
                                    ((130, 128, 512), "-130x128x512"), ((37, 13, 9), "-37x13x9"))
              for s_out, tag in ((0.1, "int8_out"), (None, "f32_out"))]


@pytest.mark.parametrize("s_out,shape", INT8_CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_int8_matmul_requant_plain_version_matches_pallas(s_out, shape, relu):
    xq, wq, scale, bias, _ = _int8_case(*shape, seed=6)
    want = np.asarray(jax_int8_requant(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                       jnp.asarray(bias), s_out=s_out, relu=relu,
                                       interpret=True))
    got = int8_matmul_requant(_t(xq, torch.int8), _t(wq.T, torch.int8), _t(scale), _t(bias),
                              s_out=s_out, relu=relu)
    _compare_int8(got, want)


@pytest.mark.parametrize("s_out,shape", INT8_CASES)
def test_int8_matmul_residual_requant_plain_version_matches_pallas(s_out, shape):
    xq, wq, scale, bias, idq = _int8_case(*shape, seed=7)
    want = np.asarray(jax_int8_residual(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                        jnp.asarray(bias), jnp.asarray(idq), 0.03,
                                        s_out=s_out, interpret=True))
    got = int8_matmul_residual_requant(_t(xq, torch.int8), _t(wq.T, torch.int8), _t(scale),
                                       _t(bias), _t(idq, torch.int8), 0.03, s_out=s_out)
    _compare_int8(got, want)


@pytest.mark.parametrize("K", [13, 64, 100])
def test_int8_pad_k16_leaves_the_plain_version_bitwise_equal(K):
    xq, wq, scale, bias, idq = (torch.from_numpy(a) for a in _int8_case(37, K, 9, seed=8))
    wq = wq.t().contiguous()
    # An unaligned start: a view one byte into a larger buffer.
    xq_off = torch.zeros(37 * K + 1, dtype=torch.int8)
    xq_off[1:] = xq.reshape(-1)
    xq_off = xq_off[1:].view(37, K)
    xp, wp = pad_k16(xq_off, wq)
    assert xp.shape[1] % 16 == 0 and xp.shape[1] - K < 16 and wp.shape[1] == xp.shape[1]
    assert xp.data_ptr() % 16 == 0 and wp.data_ptr() % 16 == 0
    assert torch.equal(xp[:, :K], xq) and not xp[:, K:].any() and not wp[:, K:].any()
    for s_out in (0.1, None):
        for relu in (True, False):
            assert torch.equal(int8_matmul_requant_reference(xp, wp, scale, bias, s_out, relu),
                               int8_matmul_requant_reference(xq, wq, scale, bias, s_out, relu))
        assert torch.equal(
            int8_matmul_residual_requant_reference(xp, wp, scale, bias, idq, 0.03, s_out),
            int8_matmul_residual_requant_reference(xq, wq, scale, bias, idq, 0.03, s_out))
    # torch's CPU allocator aligns to 64 bytes: an aligned K % 16 == 0 pair
    # passes through uncopied.
    xa, wa = xq.clone(), wq.clone()
    assert (pad_k16(xa, wa)[0] is xa) == (K % 16 == 0)
