"""The port's CNN backbones against the JAX package on the CPU: VGG16 and
ResNet50 in every variant, ``FeatureExtractor``, int8 calibration and
features, the weight bridge and weight files written by either package.
The JAX weights (numpy-seeded BN statistics for ResNet50, so that folding
is not the identity) reach the port through the bridge; tolerances are the
JAX tests' own (tests/test_backbones.py) unless stated."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_captioning_tpu.cli import convert_weights as jax_cw
from video_captioning_tpu.config import Config
from video_captioning_tpu.models.backbones import FeatureExtractor as JaxFeatureExtractor
from video_captioning_tpu.models.backbones import resnet as jax_resnet
from video_captioning_tpu.models.backbones import resnet_int8 as jax_rint8
from video_captioning_tpu.models.backbones import vgg as jax_vgg
from video_captioning_tpu.models.backbones import vgg_int8 as jax_vint8
from video_captioning_tpu_torch.cli import convert_weights as port_cw
from video_captioning_tpu_torch.config import Config as PortConfig
from video_captioning_tpu_torch.models.backbones import FeatureExtractor
from video_captioning_tpu_torch.models.backbones import resnet, resnet_int8, vgg, vgg_int8
from video_captioning_tpu_torch.models.weights import (
    backbone_state_dict_from_jax,
    init_backbone_params_numpy,
    jax_backbone_params_from_state_dict,
    load_backbone_state,
)

# int8 against int8 on the same quantized tree: the JAX cross contract
# (test_backbones.py:498); int8 against float32 (test_backbones.py:461-462).
INT8_CROSS_COS = 0.995
INT8_VS_F32 = (0.99, 0.12)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _close(got, want):
    """float32 through up to 50 conv layers whose activations reach ~1e2
    with these weights: within 1e-4 relative and 1e-5 of the largest
    |feature| absolute (sums in another order; near-zero features carry the
    rounding of their large neighbours)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def resnet_params():
    """ResNet50 in the JAX layout with init_resnet50's He-normal convs and
    randomized BN statistics (numpy draws)."""
    return init_backbone_params_numpy("resnet50", seed=0)


@pytest.fixture(scope="module")
def vgg_params():
    """VGG16 in the JAX layout with init_vgg16's distributions (numpy draws:
    jax.random takes seconds for the 138M parameters on the CPU)."""
    return init_backbone_params_numpy("vgg16", seed=1)


def _port_model(params, model_type):
    model = vgg.VGG16() if model_type == "vgg16" else resnet.ResNet50()
    load_backbone_state(model, backbone_state_dict_from_jax(params, model_type))
    return model.to(memory_format=torch.channels_last).eval()


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _frames(n, size, seed):
    return np.random.RandomState(seed).randint(0, 255, (n, size, size, 3), np.uint8)


@pytest.mark.parametrize("model_type", ["vgg16", "resnet50"])
def test_bridge_round_trip_is_exact(model_type, resnet_params, vgg_params):
    params = vgg_params if model_type == "vgg16" else resnet_params
    state = backbone_state_dict_from_jax(params, model_type)
    model = vgg.VGG16() if model_type == "vgg16" else resnet.ResNet50()
    model.load_state_dict(state, strict=False)  # names and shapes are the module's
    assert set(state) == {k for k in model.state_dict() if "num_batches" not in k}
    back = jax_backbone_params_from_state_dict(state, model_type)
    loader = jax_vgg.load_torch_vgg16 if model_type == "vgg16" else jax_resnet.load_torch_resnet50
    jax_back = loader({k: v.numpy() for k, v in state.items()})
    for want in (params, jax_back):
        got = _leaves(back)
        assert [p for p, _ in _leaves(want)] == [p for p, _ in got]
        for (path, a), (_, b) in zip(_leaves(want), got):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_init_backbone_params_numpy_layout():
    for model_type, init in (("vgg16", jax_vgg.init_vgg16), ("resnet50", jax_resnet.init_resnet50)):
        ours = init_backbone_params_numpy(model_type, seed=3)
        ref = jax.eval_shape(init, jax.random.PRNGKey(0))
        assert ([(p, x.shape) for p, x in _leaves(ours)]
                == [(p, x.shape) for p, x in _leaves(ref)])
    bn = init_backbone_params_numpy("resnet50", seed=3)["bn1"]
    assert bn["var"].min() > 0 and np.abs(bn["mean"]).max() > 0  # folding is not the identity


@pytest.fixture(scope="module")
def vgg_model(vgg_params):
    return _port_model(vgg_params, "vgg16")


@pytest.mark.parametrize("size,batch", [(64, 2), (224, 1)])
def test_vgg16_matches_jax(vgg_params, vgg_model, size, batch):
    x = _images(batch, size, seed=2)
    want = np.asarray(jax_vgg.apply_vgg16(jax.tree_util.tree_map(jnp.asarray, vgg_params),
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = vgg.apply_vgg16(vgg_model, torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 4096)
    _close(got, want)


@pytest.fixture(scope="module")
def resnet_case(resnet_params):
    x = _images(2, 64, seed=4)
    jp = jax.tree_util.tree_map(jnp.asarray, resnet_params)
    model = _port_model(resnet_params, "resnet50")
    return x, jp, jax_resnet.fold_bn(jp), model, resnet.fold_bn(model)


def test_fold_bn_matches_jax(resnet_case):
    _, _, jfold, _, pfold = resnet_case

    def jax_layout(tree):
        if isinstance(tree, dict):
            out = {k: jax_layout(v) for k, v in tree.items()}
            if "w" in out:
                out["w"] = out["w"].T
            if "kernel" in out:
                out["kernel"] = out["kernel"].transpose(2, 3, 1, 0)
            return out
        if isinstance(tree, list):
            return [jax_layout(v) for v in tree]
        return tree.detach().numpy()

    got, want = _leaves(jax_layout(pfold)), _leaves(jfold)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("variant", ["xla", "folded", "fused", "fused_s2d"])
def test_resnet50_variants_match_jax(resnet_case, variant):
    x, jp, jfold, model, pfold = resnet_case
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if variant == "xla":
            want = jax_resnet.apply_resnet50(jp, jnp.asarray(x))
            got = resnet.apply_resnet50(model, xt)
        else:
            fused = variant != "folded"
            want = jax_resnet.apply_resnet50_folded(jfold, jnp.asarray(x), use_pallas=fused,
                                                    stem_s2d=variant == "fused_s2d",
                                                    interpret=True)
            got = resnet.apply_resnet50_folded(pfold, xt, use_pallas=fused,
                                               stem_s2d=variant == "fused_s2d")
    assert got.shape == (2, 2048)
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory, resnet_params, vgg_params):
    """vcw-v1 files of the JAX weights, written by the JAX package."""
    d = tmp_path_factory.mktemp("weights")
    paths = {}
    for model_type, params in (("resnet50", resnet_params), ("vgg16", vgg_params)):
        paths[model_type] = d / f"{model_type}.vcw.npz"
        jax_cw._save_checksummed_npz(paths[model_type], jax_cw.NATIVE_FORMAT, model_type, params)
    return paths


@pytest.mark.parametrize("model_type,variant,dtype", [
    ("vgg16", "xla", "float32"),
    ("resnet50", "xla", "float32"),
    ("resnet50", "folded", "float32"),
    ("resnet50", "fused", "float32"),
    ("resnet50", "fused_s2d", "float32"),
    ("resnet50", "fused", "bfloat16"),
])
def test_feature_extractor_matches_jax(weight_files, model_type, variant, dtype):
    frames = _frames(4, 64, seed=5)
    cfg = Config()
    cfg.kernels.interpret = True  # the JAX fused kernel in interpret mode
    jfx = JaxFeatureExtractor(model_type, cfg, weights_path=weight_files[model_type],
                              batch_size=4, variant=variant, compute_dtype=dtype)
    fx = FeatureExtractor(model_type, PortConfig(), weights_path=weight_files[model_type],
                          batch_size=3, variant=variant, compute_dtype=dtype, device="cpu")
    want, got = jfx.extract(frames), fx.extract(frames)
    assert got.shape == (4, fx.feature_dim) and got.dtype == np.float32
    if dtype == "float32":
        _close(got, want)
    else:
        # The JAX bf16 contract (test_backbones.py:436), against JAX's bf16
        # and its float32 features.
        f32 = JaxFeatureExtractor(model_type, cfg, weights_path=weight_files[model_type],
                                  batch_size=4, variant=variant).extract(frames)
        for ref in (want, f32):
            assert np.mean(np.abs(got - ref)) / np.mean(np.abs(ref)) < 0.15


def test_feature_extractor_errors(weight_files, tmp_path):
    with pytest.raises(ValueError, match="pretrained weights"):
        FeatureExtractor("resnet50", None, device="cpu")
    with pytest.raises(ValueError, match="no 'folded' variant"):
        FeatureExtractor("vgg16", None, allow_random_init=True, variant="folded", device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        FeatureExtractor("resnet50", None, allow_random_init=True, compute_dtype="float16",
                         device="cpu")
    with pytest.raises(ValueError, match="Unsupported model type"):
        FeatureExtractor("alexnet", None, device="cpu")
    with pytest.raises(ValueError, match="holds resnet50 weights"):
        FeatureExtractor("vgg16", None, weights_path=weight_files["resnet50"], device="cpu")
    cfg = PortConfig()
    cfg.kernels.resnet50_variant = "fused"
    assert FeatureExtractor("resnet50", cfg, allow_random_init=True, device="cpu").variant == "fused"
    assert FeatureExtractor("resnet50", None, allow_random_init=True, device="cpu").variant == \
        "folded"


@pytest.fixture(scope="module")
def int8_case(resnet_case):
    """Calibration on 8 frames in chunks of 4 by both packages."""
    _, _, jfold, _, pfold = resnet_case
    imgs = _images(8, 64, seed=6)
    jscales = jax_rint8.calibrate_resnet50_int8(jfold, jnp.asarray(imgs), batch_size=4)
    pscales = resnet_int8.calibrate_resnet50_int8(pfold, torch.from_numpy(imgs), batch_size=4)
    return imgs, jscales, pscales


def test_int8_calibration_scales_match_jax(int8_case):
    _, jscales, pscales = int8_case
    assert set(pscales) == set(jscales)
    for site, v in jscales.items():
        assert abs(pscales[site] - v) <= 1e-5 * v, site


@pytest.fixture(scope="module")
def jax_qp(resnet_case, int8_case):
    return jax_rint8.quantize_resnet50_int8(resnet_case[2], int8_case[1])


def test_int8_quantized_tree_matches_jax(resnet_case, int8_case, jax_qp):
    pfold = resnet_case[4]
    want = jax.tree_util.tree_map(np.asarray, jax_qp)
    got = resnet_int8.quantize_resnet50_int8(pfold, int8_case[1])
    w, g = _leaves(want), _leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got))
    assert [p for p, _ in w] == [p for p, _ in g]
    n_off = n = 0
    for (path, a), (_, b) in zip(w, g):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:
            # The folded kernels agree to float32 rounding, so a weight at a
            # .5 step of its scale may round the other way.
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, path
            n_off += int((a != b).sum())
            n += a.size
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-8, err_msg=str(path))
    assert n_off <= 1e-4 * n


@pytest.mark.parametrize("use_pallas_1x1", [False, True])
def test_int8_features_match_jax(resnet_case, jax_qp, use_pallas_1x1):
    """The same quantized tree through both packages (the JAX one with its
    Pallas int8 kernels in interpret mode when the flag is on)."""
    x, pfold, qp = resnet_case[0], resnet_case[4], jax_qp
    want = jax_rint8.apply_resnet50_int8(qp, jnp.asarray(x), use_pallas_1x1=use_pallas_1x1,
                                         interpret=True)
    run = resnet_int8.int8_run_params(jax.tree_util.tree_map(np.asarray, qp), "cpu")
    got = resnet_int8.apply_resnet50_int8(run, torch.from_numpy(x), use_pallas_1x1=use_pallas_1x1)
    assert got.shape == (2, 2048)
    assert resnet_int8.feature_error(np.asarray(want), got)["mean_cosine"] > INT8_CROSS_COS
    with torch.no_grad():
        f32 = resnet.apply_resnet50_folded(pfold, torch.from_numpy(x), use_pallas=False)
    err = resnet_int8.feature_error(f32, got)
    assert err["mean_cosine"] > INT8_VS_F32[0] and err["rel_l2"] < INT8_VS_F32[1], err


def test_vgg16_int8_matches_jax(vgg_params, vgg_model):
    imgs = _images(4, 32, seed=7)  # 32 x 32: the smallest input VGG16 takes
    jp = jax.tree_util.tree_map(jnp.asarray, vgg_params)
    jscales = jax_vint8.calibrate_vgg16_int8(jp, jnp.asarray(imgs), batch_size=2)
    model = vgg_model
    pscales = vgg_int8.calibrate_vgg16_int8(model, torch.from_numpy(imgs), batch_size=2)
    assert set(pscales) == set(jscales)
    for site, v in jscales.items():
        assert abs(pscales[site] - v) <= 1e-5 * v, site
    qp = jax_vint8.quantize_vgg16_int8(jp, jscales)
    want = jax_vint8.apply_vgg16_int8(qp, jnp.asarray(imgs))
    got = vgg_int8.apply_vgg16_int8(
        resnet_int8.int8_run_params(jax.tree_util.tree_map(np.asarray, qp), "cpu"),
        torch.from_numpy(imgs))
    assert resnet_int8.feature_error(np.asarray(want), got)["mean_cosine"] > INT8_CROSS_COS
    with torch.no_grad():
        f32 = vgg.apply_vgg16(model, torch.from_numpy(imgs))
    err = resnet_int8.feature_error(f32, got)
    assert err["mean_cosine"] > INT8_VS_F32[0] and err["rel_l2"] < INT8_VS_F32[1], err


def test_int8_weight_files_move_between_packages(weight_files, tmp_path):
    """A vcw-int8-v1 file written by each package loads in the other, and
    the two int8 extractors agree on the cross contract."""
    frames = _frames(8, 64, seed=8)
    cfg = PortConfig()
    cfg.kernels.int8_conv1x1_pallas = True
    fx = FeatureExtractor("resnet50", cfg, weights_path=weight_files["resnet50"], batch_size=4,
                          variant="int8", device="cpu")
    assert not fx._int8_calibrated
    ours = fx.extract(frames)
    assert fx._int8_calibrated
    np.testing.assert_array_equal(fx.extract(frames), ours)  # calibration is one-shot
    fx.save_int8(tmp_path / "port.int8.npz")
    theirs = JaxFeatureExtractor("resnet50", None, weights_path=tmp_path / "port.int8.npz",
                                 batch_size=4).extract(frames)
    assert resnet_int8.feature_error(theirs, ours)["mean_cosine"] > INT8_CROSS_COS

    jfx = JaxFeatureExtractor("resnet50", None, weights_path=weight_files["resnet50"],
                              batch_size=4, variant="int8")
    want = jfx.extract(frames)
    jfx.save_int8(tmp_path / "jax.int8.npz")
    loaded = FeatureExtractor("resnet50", None, weights_path=tmp_path / "jax.int8.npz",
                              batch_size=4, device="cpu")
    assert loaded.variant == "int8" and loaded.model is None
    assert resnet_int8.feature_error(want, loaded.extract(frames))["mean_cosine"] > INT8_CROSS_COS
    with pytest.raises(ValueError, match="no fp32 weights"):
        loaded.calibrate_int8(frames)
    with pytest.raises(ValueError, match="variant='int8'"):
        FeatureExtractor("resnet50", None, weights_path=tmp_path / "jax.int8.npz",
                         variant="folded", device="cpu")


def test_port_written_vcw_file_loads_in_jax(resnet_params, tmp_path):
    """cli.convert_weights of the port: a torchvision-named state file to a
    vcw-v1 file that the JAX package loads to the same features."""
    state = {k: v.numpy() for k, v in backbone_state_dict_from_jax(resnet_params,
                                                                   "resnet50").items()}
    np.savez(tmp_path / "resnet50_state.npz", **state)
    port_cw.main(["--input", str(tmp_path / "resnet50_state.npz"), "--model-type", "resnet50",
                  "--output", str(tmp_path / "r.vcw.npz")])
    kind, params = jax_cw.load_native(tmp_path / "r.vcw.npz")
    assert kind == "resnet50"
    for (path, a), (_, b) in zip(_leaves(resnet_params), _leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    frames = _frames(2, 64, seed=9)
    want = JaxFeatureExtractor("resnet50", None, weights_path=tmp_path / "r.vcw.npz",
                               batch_size=2, variant="folded").extract(frames)
    got = FeatureExtractor("resnet50", None, weights_path=tmp_path / "resnet50_state.npz",
                           batch_size=2, variant="folded", device="cpu").extract(frames)
    _close(got, want)
