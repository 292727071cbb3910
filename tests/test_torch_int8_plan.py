"""The int8 1x1-conv kernel's plan (``ops/int8_matmul.py:int8_plan``) on
the CPU: at the 17 shapes of a B = 32 int8 ResNet50 forward, the same at
B = 16 (a tail batch), the odd shapes the card check runs and the edges
K = 16 and M = 1, every plan the launcher weighs covers the output tiles
exactly once and the padded K with its stages, fits a CTA's shared memory
and counts its waves of CTAs from the card's table; a plain model of the
kernel's K walk (int32 sums over 64-byte K stages of the operands as the
wrapper pads them) gives the whole product and the plain version's bits;
the int8 ResNet50 forward's dequant scales, made once with its run tree,
keep its features' bits. No JAX, no card.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from video_captioning_tpu_torch.ops import int8_matmul as im

# CTAs of each tile's kernel an NVIDIA H100 80GB HBM3 (132 SMs) runs at
# once at the shared memory a CTA may take at 1 to 4 CTAs an SM, as
# active_ctas read it: {(tile, CTAs an SM): CTAs}. The 128 x 64 tile's
# registers fit two CTAs an SM, 64 x 64's four.
H100_SMS = 132
H100_ACTIVE = {(t, per_sm): 132 * min(per_sm, most) for t, most in ((0, 2), (1, 4))
               for per_sm in (1, 2, 3, 4)}

FORWARD = [  # (residual, M, K, N, int8 out) of a B = 32 forward
    (False, 100352, 64, 64, True), (False, 100352, 64, 256, False),
    (False, 100352, 256, 64, True), (True, 100352, 64, 256, True),
    (False, 100352, 256, 128, True), (False, 25088, 128, 512, False),
    (False, 25088, 512, 128, True), (True, 25088, 128, 512, True),
    (False, 25088, 512, 256, True), (False, 6272, 256, 1024, False),
    (False, 6272, 1024, 256, True), (True, 6272, 256, 1024, True),
    (False, 6272, 1024, 512, True), (False, 1568, 512, 2048, False),
    (False, 1568, 2048, 512, True), (True, 1568, 512, 2048, True),
    (True, 1568, 512, 2048, False),
]
ODD = [(37, 13, 9), (70, 16, 72), (1, 64, 64), (1, 2048, 9), (333, 2048, 100), (333, 48, 200),
       (4001, 80, 1000), (8191, 96, 1030), (1, 16, 16), (1, 16, 2048)]
TAIL = [(res, M // 2, K, N, out) for res, M, K, N, out in FORWARD]  # B = 16
SHAPES = FORWARD + TAIL + [(res, M, K, N, out) for M, K, N in ODD for res, out in
                           ((False, True), (True, False))]


def _padded(K: int) -> int:
    return K + (-K % 16)


def _walk(M: int, N: int, plan: dict) -> list:
    """The output tiles' origins each CTA of a launch under ``plan`` walks,
    as the kernel walks them: CTA c takes tiles c, c + grid, ..., n
    fastest."""
    bm, bn = im.TILES[plan["tile"]]
    ntn, tiles = -(-N // bn), im.tile_count(M, N, plan["tile"])
    return [(t // ntn * bm, t % ntn * bn) for c in range(plan["grid"])
            for t in range(c, tiles, plan["grid"])]


@pytest.mark.parametrize("residual,M,K,N,int8_out", SHAPES)
def test_every_plan_covers_the_output_and_k_once(residual, M, K, N, int8_out):
    K = _padded(K)
    plans = im.int8_candidates(M, K, N, residual, int8_out, H100_SMS, H100_ACTIVE)
    assert plans[0] == im.int8_plan(M, K, N, residual, int8_out, H100_SMS, H100_ACTIVE)
    assert [p["cost_us"] for p in plans] == sorted(p["cost_us"] for p in plans)
    for p in plans:
        bm, bn = im.TILES[p["tile"]]
        tiles = im.tile_count(M, N, p["tile"])
        n = H100_ACTIVE[(p["tile"], p["per_sm"])]
        # Within a CTA's shared memory at that many CTAs an SM.
        assert p["smem_bytes"] == im.smem_bytes(p["tile"], p["stages"], residual, int8_out)
        assert p["smem_bytes"] <= im.SMEM_PER_CTA[p["per_sm"]] <= 232448
        assert 2 <= p["stages"] <= im.MAX_STAGES
        # Waves of CTAs follow the table: at most one CTA a tile, as many as
        # run at once.
        assert p["grid"] == min(tiles, n) and p["active"] == n
        assert p["waves"] == math.ceil(tiles / n)
        # The tiles are the (M, N) grid's, each once; the 64-byte K stages
        # cover K, the last one partly.
        assert sorted(_walk(M, N, p)) == sorted(
            (m0, n0) for m0 in range(0, M, bm) for n0 in range(0, N, bn))
        stages = -(-K // im.STAGE_K)
        assert (stages - 1) * im.STAGE_K < K <= stages * im.STAGE_K


def test_waves_follow_the_active_table():
    """Halving the CTAs the card runs at once doubles the waves of a plan
    whose tiles outnumber them; a table that runs no more 128 x 64 CTAs at
    two an SM than at one gives no such plan; an empty table none."""
    M, K, N = 1568, 2048, 512
    half = {k: v // 2 for k, v in H100_ACTIVE.items()}
    for p in im.int8_candidates(M, K, N, False, True, H100_SMS, half):
        tiles = im.tile_count(M, N, p["tile"])
        assert p["waves"] == math.ceil(tiles / half[(p["tile"], p["per_sm"])])
    one = {k: (132 if k[0] == 0 else v) for k, v in H100_ACTIVE.items()}
    plans = im.int8_candidates(M, K, N, False, True, H100_SMS, one)
    assert not any(p["tile"] == 0 and p["per_sm"] > 1 for p in plans)
    with pytest.raises(ValueError, match="no plan"):
        im.int8_plan(M, K, N, False, True, H100_SMS, {k: 0 for k in H100_ACTIVE})


@pytest.mark.parametrize("M,K,N", [(37, 13, 9), (70, 48, 72), (1, 2048, 40), (130, 200, 200)])
def test_k_stages_in_order_are_the_plain_version(M, K, N):
    """The kernel's K walk as plain PyTorch: int32 sums over the 64-byte K
    stages of the operands as ``pad_k16`` hands them over (zeros past K,
    as the TMA fills), added in order, equal the whole product, and the
    epilogue on that sum gives the plain version's bits (both kernels,
    int8 and float32 out)."""
    rng = np.random.RandomState(M + K + N)
    xq = torch.from_numpy(rng.randint(-127, 128, (M, K)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(np.int8))
    idq = torch.from_numpy(rng.randint(-127, 128, (M, N)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(N).astype(np.float32) * 4 / (64 * 73 * K ** 0.5))
    bias = torch.from_numpy(rng.randn(N).astype(np.float32) * 0.5)
    xp, wp = im.pad_k16(xq, wq)
    assert xp.shape[1] % 16 == 0 and torch.equal(xp[:, :K], xq) and not xp[:, K:].any()
    acc = torch.zeros((M, N), dtype=torch.int32)
    for k0 in range(0, xp.shape[1], im.STAGE_K):
        acc += im.int_matmul(xp[:, k0:k0 + im.STAGE_K].contiguous(),
                             wp[:, k0:k0 + im.STAGE_K].contiguous())
    assert torch.equal(acc, im.int_matmul(xq, wq))
    for s_out in (0.1, None):
        assert torch.equal(im.epilogue(acc, scale, bias, s_out, relu=True),
                           im.int8_matmul_requant_reference(xq, wq, scale, bias, s_out))
        assert torch.equal(im.epilogue(acc, scale, bias, s_out, idq=idq, s_id=0.03),
                           im.int8_matmul_residual_requant_reference(xq, wq, scale, bias, idq,
                                                                     0.03, s_out))


def test_cached_dequant_scales_keep_the_int8_features():
    """The int8 ResNet50 with the int8 pair takes each conv's ``scale *
    s_x`` from its run tree (made once, by ``int8_run_params``): all 32
    kernel calls of a forward get a tensor of the tree, and the features
    equal, bit for bit, those of a forward that makes every product at its
    call from the scale of the conv's input at that point."""
    from video_captioning_tpu_torch.config import Config
    from video_captioning_tpu_torch.models.backbones import FeatureExtractor, resnet_int8

    cfg = Config()
    cfg.kernels.int8_conv1x1_pallas = True
    fx = FeatureExtractor("resnet50", cfg, allow_random_init=True, variant="int8", device="cpu")
    frames = np.random.RandomState(3).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    fx.calibrate_int8(frames)
    run = resnet_int8.int8_run_params(fx._qp, "cpu")
    x = fx._normalize(torch.from_numpy(frames))
    made = {id(block[conv]["scale_x"]): (block[conv]["scale"], block[s])
            for blocks in run["stages"] for block in blocks
            for conv, s in (("conv1", "s_in"), ("conv3", "s_y2"))}
    calls = []

    def at_each_call(kernel):
        def call(xq, wq, scale, *args, **kwargs):
            w_scale, s_x = made[id(scale)]  # a tensor of the run tree
            calls.append(kernel.__name__)
            return kernel(xq, wq, w_scale * s_x, *args, **kwargs)
        return call

    cached = resnet_int8.apply_resnet50_int8(run, x, use_pallas_1x1=True).numpy()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("int8_matmul_requant", "int8_matmul_residual_requant"):
            mp.setattr(resnet_int8, name, at_each_call(getattr(resnet_int8, name)))
        each_call = resnet_int8.apply_resnet50_int8(run, x, use_pallas_1x1=True).numpy()
    assert calls.count("int8_matmul_requant") == 20
    assert calls.count("int8_matmul_residual_requant") == 12
    assert np.array_equal(cached, each_call)
    assert np.array_equal(cached, fx.extract(frames))
