"""The port's kernel modules on the CPU: each plain version against the JAX
Pallas kernel it stands for (run in interpret mode), the CPU dispatch of
the wrappers, and the build's refusal to fall back where nvcc is absent.
The CUDA kernels themselves are checked against these plain versions on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_captioning_tpu.ops.lstm_seq_pallas import lstm_seq_pallas
from video_captioning_tpu.ops.topk_pallas import topk2d_lse_pallas
from video_captioning_tpu_torch.ops import build, launch_counts, reset_launch_counts
from video_captioning_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_reference
from video_captioning_tpu_torch.ops.topk import topk2d_lse, topk2d_lse_reference


def _lstm_inputs(T=7, B=5, H=16, seed=0, ragged=True):
    rs = np.random.RandomState(seed)
    xproj = (rs.randn(T, 2, B, 4 * H) * 0.8).astype(np.float32)
    w_hh = (rs.uniform(-1, 1, (2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    if not ragged:
        return xproj, w_hh, None
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T  # one full row
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return xproj, w_hh, mask


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("B", [5, 8])
def test_lstm_seq_reference_matches_pallas_f32(B, ragged):
    xproj, w_hh, mask = _lstm_inputs(B=B, ragged=ragged, seed=B)
    want_o, (want_h, want_c) = lstm_seq_pallas(
        jnp.asarray(xproj), jnp.asarray(w_hh),
        None if mask is None else jnp.asarray(mask), interpret=True)
    got_o, (got_h, got_c) = lstm_seq_reference(
        torch.from_numpy(xproj), torch.from_numpy(w_hh).to(torch.bfloat16),
        None if mask is None else torch.from_numpy(mask))
    # Same bf16 operands and float32 gate math; only the float32 sum order
    # of the recurrent product differs.
    for got, want in ((got_o, want_o), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if mask is not None:  # padded steps emit exactly zero
        assert np.all(got_o.numpy().transpose(0, 2, 1, 3)[mask.T == 0] == 0)


def test_lstm_seq_reference_matches_pallas_bf16():
    xproj, w_hh, mask = _lstm_inputs(B=6, seed=3)
    x16 = jnp.asarray(xproj).astype(jnp.bfloat16)
    want_o, (want_h, want_c) = lstm_seq_pallas(
        x16, jnp.asarray(w_hh), jnp.asarray(mask), interpret=True)
    got_o, (got_h, got_c) = lstm_seq_reference(
        torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(w_hh).to(torch.bfloat16), torch.from_numpy(mask))
    assert got_o.dtype == torch.bfloat16
    # Outputs are rounded to bf16 (8 bits of mantissa): one bf16 ulp at |x| < 1.
    for got, want in ((got_o, want_o), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=2 ** -8)


def _topk_inputs(N=64, V=300, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(N, V) * 3).astype(np.float32)
    x[5, [7, 100, 299]] = 9.5          # tie at the top
    x[6, :] = 1.25                      # whole row tied
    x[7, 40:60] = x[7].max()            # run of ties
    x[8, 150:] = -np.inf                # -inf tail
    return x


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk2d_lse_reference_matches_pallas(k):
    x = _topk_inputs(seed=k)
    xp = np.pad(x, ((0, 0), (0, 384 - x.shape[1])), constant_values=-np.inf)
    want_v, want_i, want_lse = topk2d_lse_pallas(jnp.asarray(xp), k, interpret=True)
    got_v, got_i, got_lse = topk2d_lse_reference(torch.from_numpy(x), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-6)


def test_topk2d_lse_reference_all_neg_inf_row():
    x = torch.full((3, 40), float("-inf"))
    x[1, 3] = 0.0
    vals, idx, lse = topk2d_lse_reference(x, 4)
    assert torch.isneginf(lse[0]) and torch.isneginf(lse[2])
    assert lse[1].item() == 0.0
    assert idx[0].tolist() == [0, 1, 2, 3]  # lax.top_k order among equal -inf
    assert idx[1].tolist() == [3, 0, 1, 2]


def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    reset_launch_counts()
    x = torch.from_numpy(_topk_inputs())
    got = topk2d_lse(x, 5)
    want = topk2d_lse_reference(x, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    xproj, w_hh, mask = (torch.from_numpy(a) for a in _lstm_inputs())
    w16 = w_hh.to(torch.bfloat16)
    got_o, (got_h, _) = lstm_seq(xproj, w16, mask)
    want_o, (want_h, _) = lstm_seq_reference(xproj, w16, mask)
    assert torch.equal(got_o, want_o) and torch.equal(got_h, want_h)
    assert launch_counts() == {"lstm_seq": 0, "topk2d_lse": 0, "lstm_seq_train_fwd": 0,
                               "lstm_seq_train_bwd": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 20)
    with pytest.raises(ValueError):
        topk2d_lse(x, 17)
    with pytest.raises(ValueError):
        topk2d_lse(x.double(), 3)
    with pytest.raises(ValueError):
        topk2d_lse(x.T, 3)  # not contiguous
    # Neither CPU nor CUDA: no plain-version fallback.
    with pytest.raises(ValueError):
        topk2d_lse(torch.empty(4, 20, device="meta"), 3)
    xproj = torch.zeros(3, 2, 4, 32)
    with pytest.raises(ValueError):
        lstm_seq(xproj, torch.zeros(2, 8, 32), None)  # W_hh not bf16
    with pytest.raises(ValueError):
        lstm_seq(xproj, torch.zeros(2, 8, 32, dtype=torch.bfloat16), torch.ones(4, 2))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("topk_lse")
    assert not (tmp_path / "build").exists()
