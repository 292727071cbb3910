"""The recurrence kernels' plain versions at the wide form's widths (H past
the narrow form's 600, up to the kernels' limit of 1024), against the JAX
Pallas kernels they stand for, run in interpret mode as
tests/test_torch_ops.py and tests/test_torch_train.py run them at small H.
The wide CUDA forms themselves are held to these plain versions on the
card by chip_smoke.py (``check_lstm`` and ``check_lstm_train`` with
H = 1024, ``check_lstm_edges``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.ops.lstm_seq_pallas import lstm_seq_pallas
from video_captioning_tpu.ops.lstm_seq_pallas import lstm_seq_train as j_lstm_seq_train
from video_captioning_tpu_torch.ops.lstm_seq import lstm_seq_reference
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd_reference,
)


def _inputs(T, B, H, seed):
    """xproj (T, 2, B, 4H), w_hh (2, H, 4H) float32 and a ragged mask whose
    first row is full and whose last row (the only one at B = 1) has
    length 1."""
    rs = np.random.RandomState(seed)
    xproj = (rs.randn(T, 2, B, 4 * H) * 0.8).astype(np.float32)
    w_hh = (rs.uniform(-1, 1, (2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    lengths[-1] = 1
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return xproj, w_hh, mask


# H = 608: just past the narrow form; 1024: the wide form's limit.
@pytest.mark.parametrize("H", [608, 1024])
@pytest.mark.parametrize("B,T", [(1, 4), (3, 4), (3, 1)])
def test_wide_lstm_seq_reference_matches_pallas_f32(H, B, T):
    xproj, w_hh, mask = _inputs(T, B, H, seed=H + B + T)
    want_o, (want_h, want_c) = lstm_seq_pallas(
        jnp.asarray(xproj), jnp.asarray(w_hh), jnp.asarray(mask), interpret=True)
    got_o, (got_h, got_c) = lstm_seq_reference(
        torch.from_numpy(xproj), torch.from_numpy(w_hh).to(torch.bfloat16),
        torch.from_numpy(mask))
    # The tolerance of the H <= 600 test (tests/test_torch_ops.py): the same
    # bf16 operands and float32 gate math; only the float32 sum order of
    # the recurrent product differs.
    for got, want in ((got_o, want_o), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.all(got_o.numpy().transpose(0, 2, 1, 3)[mask.T == 0] == 0)


@pytest.mark.parametrize("H", [608, 1024])
def test_wide_lstm_seq_reference_matches_pallas_bf16(H):
    xproj, w_hh, mask = _inputs(4, 3, H, seed=H)
    x16 = jnp.asarray(xproj).astype(jnp.bfloat16)
    want_o, (want_h, want_c) = lstm_seq_pallas(
        x16, jnp.asarray(w_hh), jnp.asarray(mask), interpret=True)
    got_o, (got_h, got_c) = lstm_seq_reference(
        torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(w_hh).to(torch.bfloat16), torch.from_numpy(mask))
    assert got_o.dtype == torch.bfloat16
    # The H <= 600 test's tolerance: outputs are rounded to bf16, one bf16
    # ulp at |x| < 1.
    for got, want in ((got_o, want_o), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=2 ** -8)


@pytest.mark.parametrize("B", [1, 3])
def test_wide_lstm_seq_train_references_match_jax_vjp(B):
    """The plain forward and backward at H = 608 against ``jax.vjp`` of the
    JAX ``lstm_seq_train`` (its forward and backward Pallas kernels in
    interpret mode), with nonzero cotangents of the outputs and of the
    final h and c. The H <= 600 test's tolerance
    (tests/test_torch_train.py): 1e-3 of each output's largest value, as a
    float32 sum in another order can move one bf16 rounding of h or of the
    dgates by an ulp."""
    T, H = 4, 608
    xproj, w_hh, mask = _inputs(T, B, H, seed=B)
    rs = np.random.RandomState(10 + B)
    douts = rs.randn(T, 2, B, H).astype(np.float32)
    dh_last, dc_last = (rs.randn(2, B, H).astype(np.float32) for _ in range(2))

    (want_o, (want_h, want_c)), vjp = jax.vjp(
        lambda x, w: j_lstm_seq_train(x, w, jnp.asarray(mask), 128, True),
        jnp.asarray(xproj), jnp.asarray(w_hh))
    want_dx, want_dw = vjp((jnp.asarray(douts), (jnp.asarray(dh_last), jnp.asarray(dc_last))))

    x, w, m = (torch.from_numpy(xproj), torch.from_numpy(w_hh).to(torch.bfloat16),
               torch.from_numpy(mask))
    outs, h_last, c_last, gact, h_keep, c_keep = lstm_seq_train_fwd_reference(x, w, m)
    dx, dw = lstm_seq_train_bwd_reference(gact, h_keep, c_keep, w, m, torch.from_numpy(douts),
                                          torch.from_numpy(dh_last), torch.from_numpy(dc_last))
    for got, ref in zip((outs, h_last, c_last, dx, dw),
                        (want_o, want_h, want_c, want_dx, want_dw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
