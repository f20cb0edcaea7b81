"""End-to-end parity of the torch port's per-frame path
(runtime/fused.py::build_fused_frame_fn) against the JAX package, on the
CPU, with a small ViT, the same JAX-initialised weights on both sides and
frames from assets/sequences/demo_mission.npz."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.models import get_model as jget_model
from wild_visual_navigation_tpu.models import vit as jvit
from wild_visual_navigation_tpu.ops import pixelwise_fused as jfused
from wild_visual_navigation_tpu.ops.resize import imagenet_normalize
from wild_visual_navigation_tpu.runtime.fused import build_fused_frame_fn as jbuild
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn as tbuild
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg
from wild_visual_navigation_tpu_torch.utils.params import mlp_state_from_jax, vit_state_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, S = 64, 20
VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, pos_grid_size=8, layerscale_init=None)
MAP_ATOL = 2e-3  # trav and conf


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jv = jvit.VisionTransformer(jvit.ViTConfig(**VIT), attention_impl="xla", dtype=jnp.float32)
    vparams = jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, SIZE, SIZE)))
    tv = tvit.VisionTransformer(tvit.ViTConfig(**VIT), dtype=torch.float32)
    tv.load_state_dict(vit_state_from_jax(_np(vparams)))
    heads = {}
    for name, cfg in [("SimpleMLP", {"input_size": 64, "hidden_sizes": [64, 32, 1], "reconstruction": True}),
                      ("DoubleMLP", {"input_size": 64, "hidden_sizes": [32, 1]})]:
        mcfg = {"name": name, f"{'simple' if name == 'SimpleMLP' else 'double'}_mlp_cfg": cfg}
        jm = jget_model(mcfg)
        mparams = _np(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 64))))
        tm = get_model(mcfg)
        tm.load_state_dict(mlp_state_from_jax(mparams))
        heads[name] = (jm, mparams, tm)
    frames = np.load(os.path.join(ROOT, "assets/sequences/demo_mission.npz"))["frame_images"][:2]
    # confidence statistics at the scale of this head's reconstruction error
    feat = jvit.dense_features(jv, vparams, imagenet_normalize(frames[:1]))
    _, reco = jfused.pixelwise_score_fused(heads["SimpleMLP"][1], feat, SIZE, SIZE)
    m, s = float(np.mean(reco)), float(np.std(reco))
    jst = jcg.confidence_init()._replace(mean=jnp.float32(m), std=jnp.float32(s))
    tst = tcg.confidence_init()._replace(mean=torch.tensor(m), std=torch.tensor(s))
    return jv, vparams, tv, heads, frames, jst, tst


def _pair(setup, head="SimpleMLP", **kw):
    jv, vparams, tv, heads, _, jst, tst = setup
    jm, mparams, tm = heads[head]
    cfg = jcg.ConfidenceConfig(std_factor=0.5)
    jframe = jbuild(jv, jm, cfg, SIZE, num_segments=S, max_edges=256, **kw)
    tframe = tbuild(tv, tm, tcg.ConfidenceConfig(std_factor=0.5), SIZE, num_segments=S, max_edges=256, **kw)
    return (lambda img: jframe(vparams, mparams, jst, img)), (lambda img: tframe(tst, torch.from_numpy(img))), tframe


def _check_maps(got, want, seg_agree=0.99):
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    assert got.traversability.shape == want["traversability"].shape
    assert np.mean(got.segments.numpy() == want["segments"]) >= seg_agree
    np.testing.assert_allclose(got.traversability.numpy(), want["traversability"], atol=MAP_ATOL)
    np.testing.assert_allclose(got.confidence.numpy(), want["confidence"], atol=MAP_ATOL)


def test_frame_slic_per_pixel_matches_jax(setup):
    """The default path: SLIC, per-pixel fused scorer."""
    jf, tf, tframe = _pair(setup)
    frames = setup[4]
    want = jf(frames[:1])
    got = tf(frames[:1])
    _check_maps(got, want)
    assert got.segments.dtype == torch.int32 and int(got.segments.max()) < S
    assert got.edges.shape == (2, 256) and got.centers.shape == (S, 2) and got.features.shape == (S, 64)

    # the tail fed JAX's own features and segmentation: identical edges,
    # centres within 1e-4, pooled features within 1e-5
    _, _, _, _, _, _, tst = setup
    feat = np.array(jvit.dense_features(setup[0], setup[1], imagenet_normalize(frames[:1])))
    tail = tframe.tail(tst, torch.from_numpy(feat), torch.from_numpy(np.array(want.segments))[None])
    np.testing.assert_array_equal(tail.edges[0].numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(tail.edge_valid[0].numpy(), np.asarray(want.edge_valid))
    np.testing.assert_allclose(tail.centers[0].numpy(), np.asarray(want.centers), atol=1e-4)
    np.testing.assert_allclose(tail.features[0].numpy(), np.asarray(want.features), atol=1e-5)
    np.testing.assert_array_equal(tail.feat_valid[0].numpy(), np.asarray(want.feat_valid))
    np.testing.assert_allclose(tail.traversability[0].numpy(), np.asarray(want.traversability), atol=MAP_ATOL)


def test_frame_uint8_resize_crop_and_batch_match_jax(setup):
    """uint8 input, a non-square frame that is resized and centre-cropped,
    and frames_batch at B=2."""
    jf, tf, tframe = _pair(setup)
    big = (np.random.default_rng(0).random((1, 3, 48, 80)) * 255).astype(np.uint8)
    _check_maps(tf(big), jf(big))
    frames = setup[4]
    jv, vparams, _, heads, _, jst, tst = setup
    jframe = jbuild(jv, heads["SimpleMLP"][0], jcg.ConfidenceConfig(std_factor=0.5), SIZE, num_segments=S,
                    max_edges=256)
    want = jframe.frames_batch(vparams, heads["SimpleMLP"][1], jst, frames)
    got = tframe.frames_batch(tst, torch.from_numpy(frames))
    assert got.traversability.shape == (2, SIZE, SIZE)
    _check_maps(got, want)


@pytest.mark.parametrize("kw", [
    dict(segmentation_type="grid", cell_size=16),
    dict(prediction_per_pixel=False),
    dict(score_at_patch_res=True),
    dict(score_at_patch_res=True, prediction_per_pixel=False),
    dict(input_width=48),
], ids=["grid", "per-segment", "patch-res", "patch-res-per-segment", "rectangular"])
def test_frame_branches_match_jax(setup, kw):
    jf, tf, _ = _pair(setup, **kw)
    frames = setup[4]
    want = jf(frames[1:2])
    got = tf(frames[1:2])
    _check_maps(got, want)
    if kw.get("segmentation_type") == "grid":
        np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), atol=1e-3)


def test_frame_generic_head_matches_jax(setup):
    """A head outside the fused scorer's reach (DoubleMLP) is scored per
    pixel in row bands."""
    jf, tf, _ = _pair(setup, head="DoubleMLP")
    frames = setup[4]
    _check_maps(tf(frames[:1]), jf(frames[:1]))


def test_frame_rejects_unported_modes(setup):
    tv, tm = setup[2], setup[3]["SimpleMLP"][2]
    with pytest.raises(ValueError, match="segmentation"):
        tbuild(tv, tm, tcg.ConfidenceConfig(), SIZE, segmentation_type="none")
