"""The torch → JAX direction of the params bridge (utils/params.py's
`*_to_jax`), the estimator's DCP checkpoint pair, `fold_imagenet_normalize`
and `build_fused_batch_fn`, against the JAX package on the CPU.

The bridges move fp32 values and only change layouts, so every round trip
is exact. A port checkpoint carried into JAX predicts as the port does
within 1e-6 (the two frameworks' fp32 products). fold_imagenet_normalize
and build_fused_batch_fn are held to JAX's at fp32 1e-5 (summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_ranks as ranks
from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.models.registry import init_model as jinit_model
from wild_visual_navigation_tpu.runtime.fused import build_fused_batch_fn as jbuild_fused_batch_fn
from wild_visual_navigation_tpu.traversability.estimator import TraversabilityEstimator as JEstimator
from wild_visual_navigation_tpu.utils.confidence_generator import ConfidenceState as JConfidenceState
from wild_visual_navigation_tpu.utils.confidence_generator import confidence_init as jconfidence_init
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize
from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_batch_fn
from wild_visual_navigation_tpu_torch.utils import params as bridge

ATOL = 1e-5  # fp32 against JAX: summation order
PREDICT_ATOL = 1e-6  # a head's fp32 output in the two frameworks
HEADS = {
    "SimpleMLP": {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 16, "hidden_sizes": [32, 8, 1],
                                                          "reconstruction": True}},
    "DoubleMLP": {"name": "DoubleMLP", "double_mlp_cfg": {"input_size": 16, "hidden_sizes": [32, 8, 1]}},
    "SimpleGCN": {"name": "SimpleGCN", "simple_gcn_cfg": {"input_size": 16, "hidden_sizes": [32, 16, 1],
                                                          "reconstruction": True}},
    "LinearRnvp": {"name": "LinearRnvp", "linear_rnvp_cfg": {"input_size": 16, "coupling_topology": [12, 10],
                                                             "flow_n": 3, "mask_type": "odds",
                                                             "use_permutation": True, "single_function": False}},
}
VIT_CFG = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, pos_grid_size=4, layerscale_init=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb, (ta, tb)
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def _assert_state_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------------ the bridge


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_bridge_round_trips(name):
    """Every head: from_jax(to_jax(state)) and to_jax(from_jax(tree)) are
    exact, through head_state_to_jax and the head's own function."""
    cfg = HEADS[name]
    tree = _np(jinit_model(jget_model(cfg), jax.random.PRNGKey(0), 16))
    sd = bridge.head_state_from_jax(tree)
    _assert_trees_equal(bridge.head_state_to_jax(sd), tree)
    own = {"SimpleMLP": bridge.mlp_state_to_jax, "DoubleMLP": bridge.mlp_state_to_jax,
           "SimpleGCN": bridge.simple_gcn_state_to_jax, "LinearRnvp": bridge.linear_rnvp_state_to_jax}[name]
    _assert_trees_equal(own(sd), tree)
    port = get_model(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    _assert_state_dicts_equal(bridge.head_state_from_jax(bridge.head_state_to_jax(port)), port)


def test_vit_bridge_round_trips_with_quant_cal():
    """A calibrated int8_static ViT's variables (params and quant_cal, with
    layerscale) survive JAX → port → JAX exactly, and the port's calibrated
    state port → JAX → port, its 8 amax buffers included."""
    jv = jvit.VisionTransformer(jvit.ViTConfig(**VIT_CFG), attention_impl="xla", dtype=jnp.float32,
                                quant="int8_static")
    v = jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    cal = [np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)]
    v = _np(jvit.calibrate_int8_static(jv, v, cal))
    assert set(v) == {"params", "quant_cal"}
    _assert_trees_equal(bridge.vit_state_to_jax(bridge.vit_state_from_jax(v)), v)
    tv = tvit.VisionTransformer(tvit.ViTConfig(**VIT_CFG), dtype=torch.float32, device="cpu", quant="int8_static",
                                generator=torch.Generator().manual_seed(2))
    tvit.calibrate_int8_static(tv, [torch.from_numpy(c) for c in cal])
    sd = tv.state_dict()
    assert sum(k.endswith(".amax") for k in sd) == 8
    back = bridge.vit_state_from_jax(bridge.vit_state_to_jax(sd))
    _assert_state_dicts_equal(back, sd)
    fp_only = {k: v for k, v in sd.items() if not k.endswith(".amax")}
    assert set(bridge.vit_state_to_jax(fp_only)) == {"params"}


def _jax_train_state():
    """A JAX estimator's (params, opt_state, cg_state, step) after one optax
    Adam update of the SimpleMLP head, numpy."""
    jm = jget_model(HEADS["SimpleMLP"])
    params = jinit_model(jm, jax.random.PRNGKey(3), 16)
    tx = optax.adam(1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.1), params)
    updates, opt = tx.update(grads, tx.init(params))
    cg = JConfidenceState(*(jnp.asarray(np.random.default_rng(i).random(np.shape(f)), f.dtype)
                            for i, f in enumerate(jconfidence_init())))
    return _np(optax.apply_updates(params, updates)), _np(opt), _np(cg), 7


def test_train_state_bridge_round_trips():
    """train_state_to_jax(**train_state_from_jax(state)) gives JAX's state
    back exactly, its optimiser state in optax.adam's tree (count int32);
    the other way round the port's state comes back exactly. Fresh Adam
    (None) goes out as zero moments at count 0."""
    params, opt, cg, step = _jax_train_state()
    ts = bridge.train_state_from_jax(params, opt, cg, step)
    p2, o2, cg2, s2 = bridge.train_state_to_jax(**ts)
    _assert_trees_equal(p2, params)
    _assert_trees_equal(jax.tree_util.tree_leaves(o2), jax.tree_util.tree_leaves(opt))
    restored = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(opt), jax.tree_util.tree_leaves(o2))
    assert isinstance(restored[0], optax.ScaleByAdamState) and restored[0].count.dtype == np.int32
    _assert_trees_equal(JConfidenceState(**cg2), cg)
    assert s2 == step
    back = bridge.train_state_from_jax(p2, o2, cg2, s2)
    _assert_state_dicts_equal(back["params"], ts["params"])
    assert back["adam"]["step"] == ts["adam"]["step"] == 1 and back["step"] == 7
    for key in ("exp_avg", "exp_avg_sq"):
        _assert_state_dicts_equal(back["adam"][key], ts["adam"][key])
    for a, b in zip(back["cg_state"], ts["cg_state"]):
        assert torch.equal(a, b)
    fresh = bridge.train_state_to_jax(ts["params"], None, ts["cg_state"], 0)[1][0]
    assert int(fresh.count) == 0 and not any(np.any(x) for x in jax.tree_util.tree_leaves(fresh.mu))


# ------------------------------------------------------------------ the DCP pair


def test_dcp_checkpoint_round_trip_is_exact(tmp_path):
    """save_checkpoint_dcp writes dcp_{step}; load_checkpoint_dcp into a
    fresh estimator restores params, Adam's moments and step, the
    confidence state and the step exactly, and both then take the same
    next step."""
    est = ranks.dcp_train(ranks.dcp_estimator(), ranks.MLP_BATCH)
    path = est.save_checkpoint_dcp(str(tmp_path))
    assert path == str(tmp_path / "dcp_2")
    loaded = ranks.dcp_estimator()
    loaded.load_checkpoint_dcp(path)
    want, got = ranks.full_train_state(est), ranks.full_train_state(loaded)
    for part in ("params", "exp_avg", "exp_avg_sq", "cg_state"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part} {k}")
    assert (got["step"], got["adam_step"]) == (2, 2)
    for e in (est, loaded):
        ranks.dcp_train(e, ranks.MLP_BATCH)
    for k, v in est.params.items():
        assert torch.equal(loaded.params[k], v), k


def test_jax_estimator_predicts_from_a_port_dcp_checkpoint(tmp_path):
    """A port estimator's DCP checkpoint, loaded and carried over with
    train_state_to_jax into the JAX estimator (params, optax state,
    confidence state, step): JAX's head predicts as the port's within
    PREDICT_ATOL, and JAX takes the optimiser state as its own tree."""
    est = ranks.dcp_train(ranks.dcp_estimator(), ranks.MLP_BATCH)
    loaded = ranks.dcp_estimator()
    loaded.load_checkpoint_dcp(est.save_checkpoint_dcp(str(tmp_path)))
    params, opt, cg, step = bridge.train_state_to_jax(**loaded.train_state())
    jest = JEstimator(model_cfg=ranks.MLP_CFG, feature_dim=16, num_segments=4, buffer_capacity=8, image_height=8,
                      image_width=8, seed=5)
    jest._params = jax.tree_util.tree_map(jnp.asarray, params)
    jest._opt_state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jest._opt_state),
                                                   [jnp.asarray(x) for x in jax.tree_util.tree_leaves(opt)])
    jest._cg_state = JConfidenceState(**{k: jnp.asarray(v) for k, v in cg.items()})
    jest._step = step
    x = np.random.default_rng(5).standard_normal((32, 16)).astype(np.float32)
    want = np.asarray(jest._model.apply(jest._params, x))
    with torch.no_grad():
        got = loaded.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL)
    assert jest.step == 2 and int(jest._opt_state[0].count) == 2


# ------------------------------------------------------------------ item 10


def _vit_pair():
    jv = jvit.VisionTransformer(jvit.ViTConfig(**VIT_CFG), attention_impl="xla", dtype=jnp.float32)
    params = _np(jv.init(jax.random.PRNGKey(4), jnp.zeros((1, 3, 32, 32))))
    tv = tvit.VisionTransformer(tvit.ViTConfig(**VIT_CFG), dtype=torch.float32, device="cpu",
                                state_dict=bridge.vit_state_from_jax(params))
    return jv, params, tv


def test_fold_imagenet_normalize_matches_jax():
    """The folded patch embedding equals JAX's folded params at ATOL, the
    rest of the state is untouched, and the folded ViT on raw [0, 1] images
    gives the unfolded ViT's features on normalised images at ATOL."""
    jv, params, tv = _vit_pair()
    sd = tv.state_dict()
    folded = tvit.fold_imagenet_normalize(sd)
    want = bridge.vit_state_from_jax(_np(jvit.fold_imagenet_normalize(params)))
    for k in ("patch_embed.proj.weight", "patch_embed.proj.bias"):
        np.testing.assert_allclose(folded[k].numpy(), want[k].numpy(), atol=ATOL)
        assert not torch.equal(folded[k], sd[k])
    assert all(folded[k] is sd[k] for k in sd if not k.startswith("patch_embed"))
    raw = torch.from_numpy(np.random.default_rng(6).random((2, 3, 32, 32), dtype=np.float32))
    tf = tvit.VisionTransformer(tvit.ViTConfig(**VIT_CFG), dtype=torch.float32, device="cpu", state_dict=folded)
    with torch.no_grad():
        np.testing.assert_allclose(tvit.dense_features(tf, raw).numpy(),
                                   tvit.dense_features(tv, imagenet_normalize(raw)).numpy(), atol=ATOL)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_build_fused_batch_fn_matches_jax(kind):
    """frames(imgs) on (2, 3, 32, 32) frames at network size, uint8 or float
    in [0, 1]: the per-patch traversability (2, 4, 4) of JAX's function on
    the same weights at ATOL."""
    jv, params, tv = _vit_pair()
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 64, "hidden_sizes": [32, 1], "reconstruction": True}}
    jm = jget_model(cfg)
    mlp_params = _np(jinit_model(jm, jax.random.PRNGKey(5), 64))
    tm = get_model(cfg)
    tm.load_state_dict(bridge.mlp_state_from_jax(mlp_params))
    rng = np.random.default_rng(7)
    imgs = (rng.integers(0, 256, (2, 3, 32, 32), dtype=np.uint8) if kind == "uint8"
            else rng.random((2, 3, 32, 32), dtype=np.float32))
    want = np.asarray(jbuild_fused_batch_fn(jv, jm)(params, mlp_params, imgs))
    got = build_fused_batch_fn(tv, tm.eval())(torch.from_numpy(imgs))
    assert got.shape == (2, 4, 4) and want.shape == (2, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
