"""The torch port's torchvision path against the JAX package, on the CPU:
the ResNet and EfficientNet pyramids (models/resnet.py,
models/efficientnet.py) and their weight bridges, the multiscale pooling
(ops/segment_ops.py::segment_pyramid_pool), TorchVisionInterface, the
facade's torchvision modes, the fused torchvision frame and WVNRuntime in
torchvision mode.

The JAX params are filled with seeded numpy values in the flax layout
(kernels LeCun-scaled, BatchNorm statistics and biases away from the
identity so that every term is exercised), and the same values reach the
port through utils/params.py. Sizes are small (32 to 64 px)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor import torchvision_interface as jtvi_mod
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models.efficientnet import make_efficientnet as jmake_efficientnet
from wild_visual_navigation_tpu.models.resnet import make_resnet as jmake_resnet
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu.runtime import WVNRuntime as JRuntime
from wild_visual_navigation_tpu.runtime.fused import build_fused_torchvision_frame_fn as jbuild
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.cfg import experiment as tcfg_exp
from wild_visual_navigation_tpu_torch.cfg import node_params as tcfg_node
from wild_visual_navigation_tpu_torch.feature_extractor import feature_extractor as tfe_mod
from wild_visual_navigation_tpu_torch.feature_extractor.torchvision_interface import TorchVisionInterface
from wild_visual_navigation_tpu_torch.models.efficientnet import make_efficientnet
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.models.resnet import FrozenBatchNorm, make_resnet
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_torchvision_frame_fn as tbuild
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils.params import (
    efficientnet_state_from_jax,
    mlp_state_from_jax,
    resnet_state_from_jax,
    train_state_from_jax,
)

FP32_REL = 1e-5  # fp32 pyramids, of each level's largest |value| (summation order only; measured ~1e-6)
BF16_REL = 2e-2  # bf16 convolutions, of each level's largest |value|: some 5 units of bf16's 2^-8 after 20-50 layers
FEAT_ATOL = 1e-5  # pooled fp32 features
MAP_ATOL = 2e-3  # trav and conf, as the DINO frame tests hold them
LOSS_RTOL = 1e-4  # fp32 training from fp32 features that agree to 1e-5
SIZE = 48
JAX_MAKERS = {"resnet18": jmake_resnet, "resnet50": jmake_resnet, "efficientnet_b0": jmake_efficientnet}


def _bridge(params, model_type: str):
    bridge = efficientnet_state_from_jax if model_type.startswith("efficientnet") else resnet_state_from_jax
    return bridge(params)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes the
    cores, and small ops then wait tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(model_type: str, seed: int = 0):
    """Numpy params in the JAX module's flax layout, without running flax's
    initialisers (eval_shape only)."""
    shapes = jax.eval_shape(JAX_MAKERS[model_type](model_type, dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 32, 32)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", str(path[-1]))
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)  # mean, bias

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(model_type: str, params, dtype=torch.float32):
    make = make_efficientnet if model_type.startswith("efficientnet") else make_resnet
    m = make(model_type, dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(0))
    m.load_state_dict(_bridge(params, model_type))
    return m.eval().requires_grad_(False)


def _image(seed=0, shape=(1, 3, SIZE, SIZE)):
    """A blocky random image (SLIC has edges to follow)."""
    rng = np.random.default_rng(seed)
    img = rng.random(shape[:2] + (shape[2] // 4, shape[3] // 4), dtype=np.float32).repeat(4, 2).repeat(4, 3)
    return np.clip(img + 0.05 * rng.standard_normal(img.shape).astype(np.float32), 0, 1)


def _close_per_level(got: dict, want: dict, rel: float):
    assert sorted(got) == sorted(want) == ["layer1", "layer2", "layer3", "layer4"]
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, k
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= rel * scale, (k, np.abs(g - w).max() / scale)


@pytest.fixture(scope="module")
def params():
    return {mt: _jax_params(mt, seed=i) for i, mt in enumerate(JAX_MAKERS)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("model_type", list(JAX_MAKERS))
def test_pyramid_matches_jax(params, model_type, dtype):
    """Each level against the JAX module's on the same bridged weights and
    a non-square batch of two; bf16 rounds where the JAX module rounds (the
    convolutions), so it is held relative to each level's largest value."""
    jd, td, rel = {"fp32": (jnp.float32, torch.float32, FP32_REL), "bf16": (jnp.bfloat16, torch.bfloat16, BF16_REL)}[dtype]
    x = np.random.default_rng(1).standard_normal((2, 3, 48, 64)).astype(np.float32)
    want = jax.jit(JAX_MAKERS[model_type](model_type, dtype=jd).apply)(params[model_type], jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(model_type, params[model_type], td)(torch.from_numpy(x))
    _close_per_level(got, want, rel)


def test_resnet_bridge_is_the_inverse_of_the_torchvision_converter(params):
    """resnet_state_from_jax(convert_resnet_state_dict(sd)) == sd for a
    state dict under torchvision's names (the repository's converter from
    torchvision into the JAX layout), and such a state dict, step counters
    included, loads into the port's ResNet as it is."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from convert_dino_weights import convert_resnet_state_dict

    for model_type in ("resnet18", "resnet50"):
        sd = {k: v.numpy() for k, v in make_resnet(model_type, dtype=torch.float32,
                                                     generator=torch.Generator().manual_seed(3)).state_dict().items()}
        rng = np.random.default_rng(3)
        sd = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in sd.items()}
        back = resnet_state_from_jax(convert_resnet_state_dict(sd))
        assert sorted(back) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
        tv_names = {k: torch.from_numpy(v) for k, v in sd.items()}
        tv_names.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
                         for k in sd if k.endswith("running_var")})
        m = make_resnet(model_type, dtype=torch.float32)
        m.load_state_dict(tv_names)  # strict: every name of torchvision's ResNet
        assert "layer1.0.conv1.weight" in sd and ("layer1.0.downsample.0.weight" in sd) == (model_type == "resnet50")
    assert any(k.startswith("layer2.0.downsample.1.running_mean") for k in resnet_state_from_jax(params["resnet18"]))


def test_efficientnet_bridge_layout(params):
    """The flax tree's names, kernels (kh, kw, in, out) -> (out, in, kh, kw),
    depthwise (kh, kw, 1, C) -> (C, 1, kh, kw), biases and BatchNorm kept."""
    p = params["efficientnet_b0"]
    sd = efficientnet_state_from_jax(p)
    model = make_efficientnet("efficientnet_b0", dtype=torch.float32)
    assert sorted(sd) == sorted(model.state_dict())
    dw = np.asarray(p["params"]["stage1_0"]["dw_conv"]["kernel"])  # (3, 3, 1, 96)
    assert dw.shape == (3, 3, 1, 96) and tuple(sd["stage1_0.dw_conv.weight"].shape) == (96, 1, 3, 3)
    np.testing.assert_array_equal(sd["stage1_0.dw_conv.weight"][5, 0].numpy(), dw[:, :, 0, 5])
    k = np.asarray(p["params"]["stage1_0"]["project_conv"]["kernel"])  # (1, 1, 96, 24)
    np.testing.assert_array_equal(sd["stage1_0.project_conv.weight"][:, :, 0, 0].numpy(), k[0, 0].T)
    np.testing.assert_array_equal(sd["stage1_0.se.fc1.bias"].numpy(), p["params"]["stage1_0"]["se"]["fc1"]["bias"])
    np.testing.assert_array_equal(sd["stem_bn.running_var"].numpy(), p["params"]["stem_bn"]["var"])


def test_frozen_batchnorm_matches_torch_eval_batchnorm():
    """FrozenBatchNorm is BatchNorm2d in eval mode, statistics from a state dict."""
    rng = np.random.default_rng(4)
    bn = torch.nn.BatchNorm2d(8).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 8).astype(np.float32)))
    fb = FrozenBatchNorm(8)
    fb.load_state_dict(bn.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 5)).astype(np.float32))
    torch.testing.assert_close(fb(x), bn(x), rtol=1e-6, atol=1e-6)
    assert fb(x.bfloat16()).dtype == torch.float32  # bf16 in, fp32 statistics: fp32 out, as in the JAX module


def test_segment_pyramid_pool_matches_jax():
    """Sorted levels, nearest-downsampled segmentation, and the centroid
    fallback for segments that vanish at a coarse level: segment 7 is a
    single pixel, gone at every level below full resolution."""
    rng = np.random.default_rng(5)
    H, W, S = 32, 40, 9
    seg = np.repeat(np.repeat(rng.integers(0, 7, (4, 5)), 8, 0), 8, 1).astype(np.int32)
    seg[13, 21] = 7  # lost by every downsampled level
    seg[0:3, 0:3] = 8  # lost at the coarsest levels only
    pyr = {name: rng.standard_normal((c, H // s, W // s)).astype(np.float32)
           for name, c, s in [("layer3", 5, 8), ("layer1", 3, 2), ("layer4", 4, 16), ("layer2", 6, 4)]}
    want_f, want_v = jseg.segment_pyramid_pool({k: jnp.asarray(v) for k, v in pyr.items()}, jnp.asarray(seg), S)
    got_f, got_v = tseg.segment_pyramid_pool({k: torch.from_numpy(v) for k, v in pyr.items()},
                                              torch.from_numpy(seg), S)
    assert got_f.shape == (S, 18)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=FEAT_ATOL, rtol=0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the vanished segment took a level-1 feature at its centroid, not a mean
    cx, cy = int(21 * (20 / 40)), int(13 * (16 / 32))
    np.testing.assert_allclose(got_f[7, :3].numpy(), pyr["layer1"][:, cy, cx], atol=1e-6)


@pytest.mark.parametrize("model_type", ["resnet18", "efficientnet_b0"])
def test_interface_inference_matches_jax(params, model_type):
    """Resize of the smaller edge, centre crop, normalisation and the trunk,
    on a non-square uint8-range input."""
    p = params[model_type]
    jt = jtvi_mod.TorchVisionInterface(model_type=model_type, input_size=32, params=p, dtype=jnp.float32)
    tt = TorchVisionInterface(model_type=model_type, input_size=32, device="cpu", dtype=torch.float32,
                              params=_bridge(p, model_type))
    img = _image(2, (1, 3, 40, 56))
    _close_per_level(tt.inference(torch.from_numpy(img)), jt.inference(jnp.asarray(img)), FP32_REL)
    assert tt.feature_dim == jt.feature_dim and sorted(tt.params) == sorted(tt.model.state_dict())


@pytest.fixture(scope="module")
def facades(params):
    """JAX and port facades in torchvision mode (fp32 ResNet-18) per segmentation."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtvi_mod, "TorchVisionInterface", functools.partial(jtvi_mod.TorchVisionInterface,
                                                                       dtype=jnp.float32))
        for st in ("slic", "grid"):
            kw = dict(segmentation_type=st, feature_type="torchvision", input_size=SIZE, slic_num_components=16,
                      cell_size=16)
            jf = jfe_mod.FeatureExtractor(key=jax.random.PRNGKey(0), backbone_params=params["resnet18"], **kw)
            tf = tfe_mod.FeatureExtractor(device="cpu", dtype=torch.float32,
                                          backbone_params=resnet_state_from_jax(params["resnet18"]), **kw)
            out[st] = (jf, tf)
    return out


@pytest.mark.parametrize("seg", ["slic", "grid"])
def test_facade_extract_matches_jax(facades, seg):
    jf, tf = facades[seg]
    assert tf.feature_dim == jf.feature_dim == 960
    img = _image(3)
    want = jf.extract(jnp.asarray(img), return_dense_features=True)
    got = tf.extract(torch.from_numpy(img), return_dense_features=True)
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(got.center_valid.numpy(), np.asarray(want.center_valid))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=FEAT_ATOL, rtol=1e-5)
    assert got.dense_features is None and want.dense_features is None  # the pyramid mode has no dense field
    levels = tf.compute_features(torch.from_numpy(img))
    assert sorted(levels) == ["layer1", "layer2", "layer3", "layer4"] and levels["layer1"].shape == (64, 12, 12)


@pytest.fixture(scope="module")
def frames(params):
    """Both fused torchvision frames' ingredients: interfaces on the same
    fp32 ResNet-18, a SimpleMLP [960 -> 64 -> 32 -> 1+960] on the same
    weights, and confidence statistics at the scale of its reconstruction."""
    p = params["resnet18"]
    jt = jtvi_mod.TorchVisionInterface(model_type="resnet18", input_size=SIZE, params=p, dtype=jnp.float32)
    tt = TorchVisionInterface(model_type="resnet18", input_size=SIZE, device="cpu", dtype=torch.float32,
                              params=resnet_state_from_jax(p))
    mcfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 960, "hidden_sizes": [64, 32, 1],
                                                    "reconstruction": True}}
    jm = jget_model(mcfg)
    mparams = _np(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 960))))
    tm = get_model(mcfg)
    tm.load_state_dict(mlp_state_from_jax(mparams))
    pooled, _ = jseg.segment_pyramid_pool({k: v[0] for k, v in jt.inference(jnp.asarray(_image(0))).items()},
                                          jseg.segment_grid(SIZE, SIZE, 16), 9)
    out = np.asarray(jm.apply(mparams, pooled))
    reco = ((out[:, 1:] - np.asarray(pooled)) ** 2).mean(-1)
    m, s = float(reco.mean()), float(reco.std())
    jst = jcg.confidence_init()._replace(mean=jnp.float32(m), std=jnp.float32(s))
    tst = tcg.confidence_init()._replace(mean=torch.tensor(m), std=torch.tensor(s))
    return jt, tt, jm, mparams, tm, jst, tst


def _num_segments(kw):
    if kw["segmentation_type"] == "slic":
        return 16
    return (-(-SIZE // kw["cell_size"])) * (-(-kw.get("input_width", SIZE) // kw["cell_size"]))


@pytest.mark.parametrize("kw", [
    dict(segmentation_type="slic"),
    dict(segmentation_type="grid", cell_size=16),
    dict(segmentation_type="grid", cell_size=16, input_width=64),
], ids=["slic", "grid", "rectangular"])
def test_fused_frame_matches_jax(frames, kw):
    """The whole frame on a non-square uint8 frame, then the tail fed JAX's
    own pyramid and segmentation, then (square configs) frames_batch at B=2."""
    jt, tt, jm, mparams, tm, jst, tst = frames
    S = _num_segments(kw)
    jf = jbuild(jt, jm, jcg.ConfidenceConfig(std_factor=0.5), SIZE, num_segments=S, max_edges=256, **kw)
    tf = tbuild(tt, tm, tcg.ConfidenceConfig(std_factor=0.5), SIZE, num_segments=S, max_edges=256, **kw)
    img = (_image(4, (1, 3, 56, 72)) * 255).astype(np.uint8)
    want = jf(jt.params, mparams, jst, jnp.asarray(img))
    got = tf(tst, torch.from_numpy(img))
    W = kw.get("input_width", SIZE)
    assert got.traversability.shape == (SIZE, W) and got.features.shape == (S, 960)
    np.testing.assert_array_equal(got.segments.numpy(), np.asarray(want.segments))
    for name in ("traversability", "confidence"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=MAP_ATOL)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=FEAT_ATOL, rtol=1e-5)
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(got.feat_valid.numpy(), np.asarray(want.feat_valid))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), atol=1e-4)

    # the tail on JAX's own pyramid and segmentation
    from wild_visual_navigation_tpu.ops.resize import imagenet_normalize, resize_image

    x = resize_image(jnp.asarray(img, jnp.float32) / 255.0, SIZE, W)
    pyr = jt.model.apply(jt.params, imagenet_normalize(x))
    tail = tf.tail(tst, {k: torch.from_numpy(np.array(v)) for k, v in pyr.items()},
                   torch.from_numpy(np.array(want.segments))[None])
    np.testing.assert_allclose(tail.features[0].numpy(), np.asarray(want.features), atol=FEAT_ATOL, rtol=1e-5)
    np.testing.assert_allclose(tail.traversability[0].numpy(), np.asarray(want.traversability), atol=MAP_ATOL)
    np.testing.assert_allclose(tail.confidence[0].numpy(), np.asarray(want.confidence), atol=MAP_ATOL)

    if "input_width" in kw:
        return  # frames_batch runs the same code on rectangles
    # frames_batch at B=2 against JAX's
    imgs = np.concatenate([_image(5), _image(6)])
    want_b = jf.frames_batch(jt.params, mparams, jst, jnp.asarray(imgs))
    got_b = tf.frames_batch(tst, torch.from_numpy(imgs))
    assert got_b.traversability.shape == (2, SIZE, W)
    np.testing.assert_array_equal(got_b.segments.numpy(), np.asarray(want_b.segments))
    np.testing.assert_allclose(got_b.traversability.numpy(), np.asarray(want_b.traversability), atol=MAP_ATOL)
    np.testing.assert_allclose(got_b.confidence.numpy(), np.asarray(want_b.confidence), atol=MAP_ATOL)


def test_fused_frame_refuses_other_segmentations(frames):
    with pytest.raises(ValueError, match="segmentation"):
        tbuild(frames[1], frames[4], tcg.ConfidenceConfig(), SIZE, segmentation_type="none")


# ------------------------------------------------------------------- runtime


def _runtime_params(mod_node, mod_exp):
    """The drive of the JAX package's own torchvision runtime test: 32 px,
    grid cells of 8, per-segment prediction, buffer 8, fan-out 4."""
    fe = mod_node.FeatureExtractorNodeParams(
        network_input_image_height=32, network_input_image_width=32, segmentation_type="grid",
        feature_type="torchvision", prediction_per_pixel=False, image_callback_rate=1000.0, grid_cell_size=8,
        camera_topics={"front": {"use_for_training": True}})
    ln = mod_node.LearningNodeParams(min_samples_for_training=2, image_graph_dist_thr=0.05,
                                     supervision_callback_rate=1000.0)
    return fe, ln, mod_exp.ExperimentParams()


def _drive(rt, n_frames=5):
    img = np.random.RandomState(0).rand(3, 40, 40).astype(np.float32)
    K = np.array([[30.0, 0, 20], [0, 30, 20], [0, 0, 1]])
    Tc = np.eye(4)
    Tc[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
    Tc[2, 3] = 2.0
    results = []
    for i in range(n_frames):
        T = np.eye(4)
        T[0, 3] = i * 0.3
        results.append(rt.image_callback(img + 0.01 * i, float(i), "front", K, 40, 40, T, Tc))
        pT = np.eye(4)
        pT[0, 3] = i * 0.3 + 0.5
        rt.robot_state_callback(float(i) + 0.1, pT, np.array([1.0, 0, 0, 0, 0, 0]), np.array([1.0, 0, 0, 0, 0, 0]))
    return results, [rt.learning_step() for _ in range(6)]


def test_runtime_torchvision_replay_matches_jax(params):
    """WVNRuntime in torchvision x grid mode (the fused frame, ResNet-18 in
    fp32) driven as the JAX package's own torchvision runtime test drives
    it, through both runtimes: the same maps, buffer rows, train steps and
    losses."""
    fe, ln, exp = _runtime_params(jcfg, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtvi_mod, "TorchVisionInterface", functools.partial(jtvi_mod.TorchVisionInterface,
                                                                       dtype=jnp.float32))
        jrt = JRuntime(fe_params=fe, ln_params=ln, exp_params=exp, key=jax.random.PRNGKey(0), buffer_capacity=8,
                       reprojection_fanout=4, backbone_params=params["resnet18"])
    fe, ln, exp = _runtime_params(tcfg_node, tcfg_exp)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, reprojection_fanout=4,
                    device="cpu", backbone_dtype=torch.float32, backbone_params=resnet_state_from_jax(params["resnet18"]))
    est = jrt.estimator
    rt.adopt_train_state(**train_state_from_jax(*_np((est.params, est._opt_state, est.confidence_state)), est.step))
    assert rt._fused_frame is not None and jrt._fused_frame is not None and rt._D == jrt._D == 960
    np.random.seed(42)
    jres, jstates = _drive(jrt)
    tres, tstates = _drive(rt)
    for j, t in zip(jres, tres):
        trav, conf = t.to_numpy()
        np.testing.assert_allclose(trav, np.asarray(j.traversability), atol=MAP_ATOL)
        np.testing.assert_allclose(conf, np.asarray(j.confidence), atol=MAP_ATOL)
    assert [s.step for s in tstates] == [s.step for s in jstates] and tstates[-1].step > 0
    assert [s.mission_graph_num_valid_node for s in tstates] == [s.mission_graph_num_valid_node for s in jstates]
    np.testing.assert_allclose([s.loss_total for s in tstates], [s.loss_total for s in jstates], rtol=LOSS_RTOL,
                               atol=1e-7)
    np.testing.assert_array_equal(rt.estimator.buffer.valid.numpy(), np.asarray(est.buffer.valid))
    np.testing.assert_allclose(rt.estimator.buffer.features.numpy(), np.asarray(est.buffer.features),
                               atol=FEAT_ATOL, rtol=1e-5)


def test_runtime_torchvision_batch_callback_matches_single_callbacks(params):
    """image_batch_callback at B=2 through frames_batch (the pyramid once on
    the batch) against two image_callbacks on a twin runtime; rectangles
    fuse (the convolutions pad)."""
    fe, ln, exp = _runtime_params(tcfg_node, tcfg_exp)
    fe.network_input_image_width = 40
    kw = dict(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, reprojection_fanout=4, device="cpu",
              backbone_dtype=torch.float32, backbone_params=resnet_state_from_jax(params["resnet18"]))
    rt_b, rt_s = WVNRuntime(**kw), WVNRuntime(**kw)
    assert rt_b._fused_frame is not None
    rng = np.random.default_rng(7)
    imgs = rng.random((2, 3, 40, 50), dtype=np.float32)
    K = np.array([[30.0, 0, 25], [0, 30, 20], [0, 0, 1]])
    Ks, pb, pc = np.stack([K, K]), np.stack([np.eye(4)] * 2), np.stack([np.eye(4)] * 2)
    pb[1, 0, 3] = 1.0
    batch = rt_b.image_batch_callback(imgs, [0.0, 1.0], ["front", "front"], Ks, 40, 50, pb, pc)
    singles = [rt_s.image_callback(imgs[i], float(i), "front", K, 40, 50, pb[i], pc[i]) for i in range(2)]
    for b, s in zip(batch, singles):
        assert b.traversability.shape == (32, 40)
        for x, y in zip(b.to_numpy(), s.to_numpy()):
            np.testing.assert_allclose(x, y, atol=1e-5)
    torch.testing.assert_close(rt_b.estimator.buffer.features, rt_s.estimator.buffer.features, atol=1e-5, rtol=0)


@pytest.mark.parametrize("build", [
    lambda: TorchVisionInterface(),
    lambda: tfe_mod.FeatureExtractor(feature_type="torchvision", input_size=32),
    lambda: WVNRuntime(fe_params=tcfg_node.FeatureExtractorNodeParams(feature_type="torchvision")),
    lambda: WVNRuntime(build_feature_extractor=False, gridmap_size=64),
], ids=["interface", "facade", "runtime", "runtime-gridmap"])
def test_torchvision_entry_points_run_on_the_card_by_default(build):
    """Without `device=` each entry point is built on the card, and raises here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        build()
