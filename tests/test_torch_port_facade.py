"""The torch port's FeatureExtractor facade
(feature_extractor/feature_extractor.py) against the JAX facade, on the
CPU: DINO ViT-S/8 at 32 px with the same JAX-initialised weights on both
sides, fp32 on both, and seeded numpy images. Also the pixel-wise and
random segmentations, the static shape helpers, the unported options, and
the route of SLIC on a card (a meta tensor stands in for a CUDA one: no
kernel runs here)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu_torch.feature_extractor import feature_extractor as tfe_mod
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.ops import slic as tslic
from wild_visual_navigation_tpu_torch.utils.params import vit_state_from_jax

SIZE = 32
FEAT_ATOL = 1e-4  # fp32 features: summation order only
CENTER_ATOL = 1e-3


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


def _image(seed=0, size=SIZE):
    """A smooth random image (blocky, so SLIC has edges to follow)."""
    rng = np.random.default_rng(seed)
    img = rng.random((1, 3, size // 4, size // 4), dtype=np.float32).repeat(4, 2).repeat(4, 3)
    return np.clip(img + 0.05 * rng.standard_normal(img.shape).astype(np.float32), 0, 1)


@pytest.fixture(scope="module")
def pair():
    """A JAX facade (fp32 backbone) and a port facade holding its weights, per segmentation."""
    fp32_dino = functools.partial(JDino, dtype=jnp.float32, attention_impl="xla")
    out = {}
    params = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe_mod, "DinoInterface", fp32_dino)
        for st in ("slic", "grid", "none", "random"):
            kw = dict(segmentation_type=st, feature_type="dino", input_size=SIZE, slic_num_components=16,
                      cell_size=8, n_random_pixels=20, max_edges=256)
            jf = jfe_mod.FeatureExtractor(key=jax.random.PRNGKey(0), backbone_params=params, **kw)
            params = jf._extractor.params
            tf = tfe_mod.FeatureExtractor(seed=0, device="cpu", dtype=torch.float32,
                                          backbone_params=vit_state_from_jax(_np(params)), **kw)
            out[st] = (jf, tf)
    return out


@pytest.mark.parametrize("st", ["slic", "grid", "none"])
def test_extraction_matches_jax(pair, st):
    jf, tf = pair[st]
    img = _image(1)
    want = jf.extract(jnp.asarray(img), return_dense_features=True)
    got = tf.extract(torch.from_numpy(img), return_dense_features=True)
    seg_t, seg_j = got.segments.numpy(), np.asarray(want.segments)
    assert got.segments.dtype == torch.int32 and seg_t.shape == seg_j.shape == (SIZE, SIZE)
    agree = np.mean(seg_t == seg_j)
    if st == "slic":
        assert agree >= 0.99
    else:
        assert agree == 1.0
    np.testing.assert_allclose(got.dense_features.numpy(), np.asarray(want.dense_features), atol=FEAT_ATOL)
    assert got.features.shape == want.features.shape
    if agree == 1.0:  # pooled features, graph and centres follow the segmentation
        np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=FEAT_ATOL)
        np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
        np.testing.assert_array_equal(got.edge_valid.numpy(), np.asarray(want.edge_valid))
        np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), atol=CENTER_ATOL)
        np.testing.assert_array_equal(got.center_valid.numpy(), np.asarray(want.center_valid))
    assert tf.num_segments(SIZE, SIZE) == jf.num_segments(SIZE, SIZE) == got.features.shape[0]
    assert tf.feature_dim == jf.feature_dim == 384


def test_uint8_extraction_matches_float(pair):
    _, tf = pair["grid"]
    img = (_image(2) * 255).astype(np.uint8)
    a = tf.extract(torch.from_numpy(img))
    b = tf.extract(torch.from_numpy(img.astype(np.float32) / 255.0))
    np.testing.assert_array_equal(a.features.numpy(), b.features.numpy())


def test_pixelwise_segmentation_and_edges_match_jax():
    for h, w in [(4, 5), (7, 3), (16, 16)]:
        np.testing.assert_array_equal(tseg.segment_pixelwise(h, w).numpy(), np.asarray(jseg.segment_pixelwise(h, w)))
        np.testing.assert_array_equal(tseg.pixelwise_edges(h, w).numpy(), np.asarray(jseg.pixelwise_edges(h, w)))


@pytest.mark.parametrize("h,w,n", [(8, 8, 10), (16, 12, 100), (5, 7, 35)])
def test_random_segmentation_structure(h, w, n):
    """JAX draws with jax.random.permutation, torch cannot: the structure
    is held, not the pixels."""
    seg = tseg.segment_random(torch.Generator().manual_seed(3), h, w, n)
    assert seg.shape == (h, w) and seg.dtype == torch.int32
    flat = seg.reshape(-1).numpy()
    assert sorted(flat[flat >= 0].tolist()) == list(range(n))  # ids 0..n-1, each on one pixel
    assert np.sum(flat == -1) == h * w - n
    again = tseg.segment_random(torch.Generator().manual_seed(3), h, w, n)
    assert torch.equal(seg, again)
    if n < h * w:
        assert not torch.equal(seg, tseg.segment_random(torch.Generator().manual_seed(4), h, w, n))
    want = np.asarray(jseg.segment_random(jax.random.PRNGKey(0), h, w, n))
    assert (want >= 0).sum() == (flat >= 0).sum() and want.max() == flat.max() == n - 1


def test_random_extraction_structure_and_pooling_of_jax_segmentation(pair):
    """The facade's random mode is deterministic per seed and keeps the
    structure; fed JAX's own random segmentation, the port pools, links
    and centres it as JAX does."""
    jf, tf = pair["random"]
    img = _image(3)
    got = tf.extract(torch.from_numpy(img))
    again = tf.extract(torch.from_numpy(img))
    assert torch.equal(got.segments, again.segments) and torch.equal(got.features, again.features)
    other = tf.extract(torch.from_numpy(img), generator=torch.Generator().manual_seed(9))
    assert not torch.equal(got.segments, other.segments)
    flat = got.segments.reshape(-1).numpy()
    assert sorted(flat[flat >= 0].tolist()) == list(range(20)) and got.features.shape == (20, 384)
    assert bool(got.center_valid.all())

    want = jf.extract(jnp.asarray(img), return_dense_features=True)
    seg = torch.from_numpy(np.array(want.segments))
    dense = torch.from_numpy(np.array(want.dense_features))
    feat, _ = tf.sparsify_features(dense, seg, 20)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want.features), atol=1e-5)
    edges, edge_valid = tseg.adjacency_list(seg, 20, max_edges=256)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(edge_valid.numpy(), np.asarray(want.edge_valid))
    centers, valid = tseg.segment_centers(seg, 20)
    np.testing.assert_allclose(centers.numpy(), np.asarray(want.centers), atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want.center_valid))


def test_static_helpers_match_jax():
    for ft in ("dino", "dinov2"):
        for bt in ("vit_tiny", "vit_small", "vit_base", "vit_large"):
            assert tfe_mod.static_feature_dim(ft, bt) == jfe_mod.static_feature_dim(ft, bt)
    for ft in ("stego", "sift", "histogram"):
        assert tfe_mod.static_feature_dim(ft) == jfe_mod.static_feature_dim(ft)
    for mt in ("resnet18", "resnet50"):
        assert tfe_mod.static_feature_dim("torchvision", model_type=mt) == \
            jfe_mod.static_feature_dim("torchvision", model_type=mt)
    for st in ("slic", "grid", "random", "stego", "none"):
        for h, w, cell in [(224, 224, 32), (48, 64, 16), (37, 29, 8)]:
            kw = dict(cell_size=cell, slic_num_components=50, n_random_pixels=33, n_image_clusters=7)
            assert tfe_mod.static_num_segments(st, h, w, **kw) == jfe_mod.static_num_segments(st, h, w, **kw)
    with pytest.raises(ValueError):
        tfe_mod.static_num_segments("bogus", 8, 8)


@pytest.mark.parametrize("kw,item", [
    (dict(feature_type="torchvision"), "item 21"),
    (dict(feature_type="sift"), None),
    (dict(feature_type="histogram"), None),
    (dict(quant="int8_static"), "item 28"),
], ids=["torchvision", "sift", "histogram", "int8"])
def test_unported_options_name_their_roadmap_item(kw, item):
    """What is not ported raises naming its ROADMAP.md item; sift and
    histogram (item 23) are ported and build with their feature dims."""
    if item is None:
        fe = tfe_mod.FeatureExtractor(device="cpu", input_size=SIZE, **kw)
        assert fe.feature_dim == jfe_mod.static_feature_dim(kw["feature_type"]) and fe._extractor is None
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1, {item}"):
        tfe_mod.FeatureExtractor(device="cpu", input_size=SIZE, **kw)


def test_slic_of_a_card_image_goes_to_slic_batch(monkeypatch):
    """`slic` runs its plain loop on CPU images only: any other device
    (here meta, standing in for CUDA) goes to slic_batch, whose step is K3;
    and with the real slic_batch a meta image reaches the kernel's wrapper,
    which refuses it."""
    calls = []

    def fake(imgs, num_components=100, compactness=10.0, iterations=10):
        calls.append((imgs.device.type, tuple(imgs.shape), num_components))
        return torch.zeros((imgs.shape[0],) + tuple(imgs.shape[2:]), dtype=torch.int32)

    img = torch.empty((3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="slic_step: unsupported device"):
        tslic.slic(img, num_components=4)
    monkeypatch.setattr(tslic, "slic_batch", fake)
    assert tslic.slic(img, num_components=4).shape == (16, 16)
    assert calls == [("meta", (1, 3, 16, 16), 4)]


def test_facade_segments_a_card_image_through_slic_batch(pair, monkeypatch):
    """The facade's SLIC route for a non-CPU image is slic_batch (the CPU
    one stays on the plain loop, checked against JAX above)."""
    _, tf = pair["slic"]
    calls = []

    def fake(imgs, num_components=100, compactness=10.0, iterations=10):
        calls.append((imgs.device.type, num_components, compactness))
        return torch.arange(SIZE * SIZE, dtype=torch.int32).reshape(1, SIZE, SIZE) % num_components

    monkeypatch.setattr(tslic, "slic_batch", fake)
    edges, edge_valid, seg, centers, valid = tf.compute_segments(torch.empty((1, 3, SIZE, SIZE), device="meta"))
    assert calls == [("meta", 16, 10)]
    assert seg.shape == (SIZE, SIZE) and centers.shape == (16, 2) and bool(valid.all())
    tf.compute_segments(torch.from_numpy(_image(4)))
    assert len(calls) == 1  # the CPU image took the plain loop
