"""Traffic and weights are the same for the same seed, and every seed
offers the same clips in another order."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import inputs

SEEDS = (0, 7, 2 ** 31 + 11)


@pytest.mark.parametrize("seed", SEEDS)
def test_clip_order_and_sample_reproduce(seed):
    o = inputs.clip_order(seed, 16, 40)
    np.testing.assert_array_equal(o, inputs.clip_order(seed, 16, 40))
    assert sorted(o[:16]) == list(range(16))  # whole permutations of the pool
    s = inputs.sample_indices(seed, 100, 10)
    np.testing.assert_array_equal(s, inputs.sample_indices(seed, 100, 10))
    assert len(set(s.tolist())) == 10


@pytest.mark.parametrize("seed", SEEDS)
def test_pools_and_weights_reproduce(seed):
    p = inputs.feature_pool(3, 4, 8, seed, "cpu")
    np.testing.assert_array_equal(p, inputs.feature_pool(3, 4, 8, seed, "cpu"))
    assert p.dtype == np.float32 and p.min() == 0.0
    f = inputs.frame_pool(2, 3, 8, 8, seed, "cpu")
    np.testing.assert_array_equal(f, inputs.frame_pool(2, 3, 8, 8, seed, "cpu"))
    assert f.dtype == np.uint8
    config = {"model": {"cnn_feature_dim": 8, "encoder_hidden_dim": 4, "decoder_hidden_dim": 4,
                        "embedding_dim": 4, "attention_dim": 4, "vocab_size": 10,
                        "encoder_num_layers": 2, "decoder_num_layers": 2},
              "weights": {"vocab_sharpen": 3.0, "suppress_end": True, "end_idx": 2}}
    a = inputs.captioner_weights(config, seed, "cpu")
    b = inputs.captioner_weights(config, seed, "cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a["decoder"]["output_projection"]["bias"][2] == -1e9
    c = inputs.captioner_weights(config, seed + 1, "cpu")
    assert not torch.equal(a["encoder"]["feature_projection"]["kernel"],
                           c["encoder"]["feature_projection"]["kernel"])


def test_the_trees_have_the_packages_layout():
    """The benchmark's trees carry the port's inference-package keys and
    shapes, so a package written from them loads."""
    from video_captioning_tpu_torch.config import Config
    from video_captioning_tpu_torch.models.weights import init_params_numpy

    for arch in ("lstm", "transformer"):
        conf = Config()
        conf.model.architecture = arch
        conf.model.cnn_feature_dim, conf.model.vocab_size = 64, 50
        leaves = (inputs.transformer_captioner_leaves if arch == "transformer"
                  else inputs.lstm_captioner_leaves)(conf.to_dict()["model"], 50)
        ours = {path: shape for path, shape, _, _ in leaves}
        theirs = {}

        def walk(node, path=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path + (i,))
            else:
                theirs[path] = tuple(node.shape)

        walk(init_params_numpy(conf, 50))
        assert ours == theirs
