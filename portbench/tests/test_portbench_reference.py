"""Each plain reference agrees with the port's CPU path (the kernels' plain
versions) at a tiny size, on the same seeded weights and inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import spec
from portbench.harness.captioning import served_scores
from portbench.reference import captioner, resnet50


def _driver(root, cell, seed):
    return spec.driver(root, cell.mix["driver"]).Driver(cell.config, cell.mix, seed, "cpu", False)


@pytest.mark.parametrize("cell", ["lstm_vgg16.beam5_bulk", "transformer_r50.beam5_bulk"])
def test_captioner_reference_matches_the_port(tiny_root, cell):
    c = spec.find_cell(tiny_root, cell)
    drv = _driver(tiny_root, c, 123)
    clips = drv.pool[:8]
    K, L = c.mix["beam_size"], c.mix["max_length"]
    out = drv.predictor._run_generation(clips, "beam", L, K, 1.0, 1.0)
    feats = torch.from_numpy(clips)
    dec = captioner.decoder_for(c.config, drv.weights, feats)
    tokens, score = captioner.beam_search(dec, 8, K, L, drv.start, drv.end, 1.0)
    np.testing.assert_array_equal(out["generated_tokens"], tokens.numpy())
    np.testing.assert_allclose(served_scores(out), score.numpy(), rtol=0, atol=2e-6)
    forced = captioner.sequence_logprob(dec, tokens, drv.end, 1.0)
    np.testing.assert_allclose(forced.numpy(), score.numpy(), rtol=0, atol=2e-6)


def test_lstm_encoder_reference_is_the_ports_kernel_contract(tiny_root):
    """With the kernels' plain versions the encoder agrees bit for bit: the
    bfloat16 recurrent product is the configuration's, not an error."""
    from video_captioning_tpu_torch.models.captioner import encode

    c = spec.find_cell(tiny_root, "lstm_vgg16.beam5_bulk")
    drv = _driver(tiny_root, c, 5)
    feats = torch.from_numpy(drv.pool[:8])
    with torch.inference_mode():
        enc, final, _ = encode(drv.predictor.model, drv.predictor.config, feats)
    ref_enc, ref_final = captioner.lstm_encode(drv.weights, feats)
    torch.testing.assert_close(enc, ref_enc, rtol=0, atol=1e-6)
    torch.testing.assert_close(final, ref_final, rtol=0, atol=1e-6)


def test_resnet50_reference_matches_the_fused_extractor(tiny_root):
    c = spec.find_cell(tiny_root, "transformer_r50.extract")
    drv = _driver(tiny_root, c, 9)
    frames = drv.pool[0]
    got = drv.extractor.extract_video(frames)
    err = resnet50.judge(drv.weights, torch.from_numpy(frames), torch.from_numpy(got))
    assert float(err["feature_rel_err"].max()) < 1e-5
