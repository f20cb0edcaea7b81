"""Parity of the torch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerances are stated per check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.ops import resize as jresize
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu.ops import slic as jslic
from wild_visual_navigation_tpu.utils import confidence_generator as jcg
from wild_visual_navigation_tpu_torch.ops import resize as tresize
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.ops import slic as tslic
from wild_visual_navigation_tpu_torch.ops import slic_fused as tslic_fused
from wild_visual_navigation_tpu_torch.utils import confidence_generator as tcg

RESIZE_ATOL = 1e-6


def _close(got: torch.Tensor, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(0).random((2, 3, 37, 53), dtype=np.float32)


@pytest.mark.parametrize("shape", [(40, 30), (37, 53), (1, 5)])
def test_resize_nearest_matches_jax(img, shape):
    _close(tresize.resize_nearest(torch.from_numpy(img), *shape), jresize.resize_nearest(img, *shape), RESIZE_ATOL)


@pytest.mark.parametrize("size", [24, 64, 100])
def test_resize_smaller_edge_and_crop_match_jax(img, size):
    _close(tresize.resize_smaller_edge_nearest(torch.from_numpy(img), size),
           jresize.resize_smaller_edge_nearest(img, size), RESIZE_ATOL)
    _close(tresize.center_crop(torch.from_numpy(img), size, size // 2 + 1),
           jresize.center_crop(img, size, size // 2 + 1), RESIZE_ATOL)


@pytest.mark.parametrize("new_hw", [(32, 32), (24, 40)])
def test_resize_image_matches_jax(img, new_hw):
    h, w = new_hw
    _close(tresize.resize_image(torch.from_numpy(img), h, w), jresize.resize_image(img, h, w), RESIZE_ATOL)


@pytest.mark.parametrize("out", [(56, 56), (23, 37), (1, 9)])
def test_interpolate_bilinear_matches_jax(out):
    x = np.random.default_rng(1).standard_normal((2, 5, 8, 7)).astype(np.float32)
    _close(tresize.interpolate_bilinear(torch.from_numpy(x), *out), jresize.interpolate_bilinear(x, *out), RESIZE_ATOL)
    _close(tresize.interpolate_bilinear_mxu(torch.from_numpy(x), *out),
           jresize.interpolate_bilinear_mxu(x, *out, precision=jax.lax.Precision.HIGHEST), 1e-5)


def test_interpolation_matrices_and_norm_sq_match_jax():
    for out, inp in [(56, 8), (23, 8), (1, 4), (5, 1)]:
        np.testing.assert_array_equal(tresize._bilinear_matrix_np(out, inp), jresize._bilinear_matrix_np(out, inp))
        for a, b in zip(tresize._bilinear_pair_matrices_np(out, inp), jresize._bilinear_pair_matrices_np(out, inp)):
            np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(2).standard_normal((2, 6, 8, 7)).astype(np.float32)
    want = jresize.interpolate_norm_sq_mxu(x, 23, 37)
    # fp32 sums of ~D squared O(1) terms: relative 1e-6
    _close(tresize.interpolate_norm_sq_mxu(torch.from_numpy(x), 23, 37), want, 1e-5, 1e-6)


def test_imagenet_normalize_matches_jax(img):
    _close(tresize.imagenet_normalize(torch.from_numpy(img)), jresize.imagenet_normalize(img), RESIZE_ATOL)


@pytest.mark.parametrize("std_factor", [0.5, 0.7, 1.0])
def test_confidence_inference_matches_jax(std_factor):
    x = np.random.default_rng(3).random(500, dtype=np.float32) * 0.3
    js = jcg.confidence_init()._replace(mean=jnp.float32(0.07), std=jnp.float32(0.024))
    ts = tcg.confidence_init()._replace(mean=torch.tensor(0.07), std=torch.tensor(0.024))
    want = jcg.confidence_inference(jcg.ConfidenceConfig(std_factor=std_factor), js, x)
    _close(tcg.confidence_inference(tcg.ConfidenceConfig(std_factor=std_factor), ts, torch.from_numpy(x)), want, 1e-6)


def test_confidence_state_dict_round_trip():
    st = tcg.confidence_init()
    st2 = tcg.confidence_load_state_dict(st, {"mean": 0.5, "var": 0.04, "std": 0.2})
    assert float(st2.std) == pytest.approx(0.2) and st2.window_sum.shape == (5,)
    d = tcg.confidence_state_dict(st2)
    assert set(d) == {"mean", "var", "std"} and float(d["mean"]) == 0.5


# ---------------------------------------------------------------- segments


@pytest.fixture(scope="module")
def jax_segmentation():
    """A JAX-made SLIC segmentation of a seeded 64x64 image and seeded
    patch features for it."""
    rng = np.random.default_rng(4)
    image = rng.random((3, 64, 64), dtype=np.float32)
    seg = np.array(jslic.slic(image, num_components=20, iterations=4))
    feat = rng.standard_normal((16, 8, 8)).astype(np.float32)
    return seg, feat


def test_segment_pooling_matches_jax(jax_segmentation):
    seg, feat = jax_segmentation
    S = 24  # > the 20 segments: empty slots stay zero
    dense = np.array(jresize.interpolate_bilinear(feat[None], 64, 64))[0]
    want, wc = jseg.segment_mean_pool(dense, seg, S)
    got, gc = tseg.segment_mean_pool(torch.from_numpy(dense), torch.from_numpy(seg), S)
    _close(got, want, 1e-5)
    _close(gc, wc, 0)
    want, wc = jseg.segment_mean_pool_upsampled(feat, seg, S, 64, 64)
    got, gc = tseg.segment_mean_pool_upsampled(torch.from_numpy(feat), torch.from_numpy(seg), S, 64, 64)
    _close(got, want, 1e-5)
    _close(gc, wc, 0)


def test_segment_centers_and_edges_match_jax(jax_segmentation):
    seg, _ = jax_segmentation
    for S, max_edges in [(24, 1024), (20, 16)]:  # 16 slots truncate to the smallest keys
        want_e, want_v = jseg.adjacency_list(seg, S, max_edges=max_edges)
        got_e, got_v = tseg.adjacency_list(torch.from_numpy(seg), S, max_edges=max_edges)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    want_c, want_cv = jseg.segment_centers(seg, 24)
    got_c, got_cv = tseg.segment_centers(torch.from_numpy(seg), 24)
    _close(got_c, want_c, 1e-4)
    np.testing.assert_array_equal(got_cv.numpy(), np.asarray(want_cv))


def test_adjacency_hash_path_matches_jax():
    """More than 256 segments take torch.unique instead of the
    co-occurrence matrix; the layout is the same."""
    seg = (np.random.default_rng(5).integers(0, 300, (20, 20)) - 1).astype(np.int32)  # -1 = unassigned
    want_e, want_v = jseg.adjacency_list(seg, 300, max_edges=600)
    got_e, got_v = tseg.adjacency_list(torch.from_numpy(seg), 300, max_edges=600)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("hwc", [(64, 64, 16), (224, 224, 32), (50, 70, 32)])
def test_grid_ops_match_jax(hwc):
    H, W, cs = hwc
    S = 64
    np.testing.assert_array_equal(tseg.segment_grid(H, W, cs).numpy(), np.asarray(jseg.segment_grid(H, W, cs)))
    for got, want in zip(tseg.grid_constants(H, W, cs, S, max_edges=256), jseg.grid_constants(H, W, cs, S, max_edges=256)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------------- SLIC


def test_rgb_to_lab_matches_jax(img):
    # cbrt against pow(1/3): a few fp32 ulps of values up to 100
    _close(tslic.rgb_to_lab(torch.from_numpy(img[0])), jslic.rgb_to_lab(img[0]), 1e-4)


def test_slic_single_step_matches_jax():
    """One assignment from the same (grid-initialised) centres, against
    the reference's XLA form: identical on >= 99.9% of pixels (the
    distance sums round in another order)."""
    image = np.random.default_rng(6).random((3, 64, 64), dtype=np.float32)
    want = np.asarray(jslic.slic(image, num_components=12, iterations=0))
    got = tslic.slic(torch.from_numpy(image), num_components=12, iterations=0).numpy()
    assert np.mean(got == want) >= 0.999


def test_slic_step_matches_jax_pallas_step():
    """One step from the same perturbed centres against the reference's
    Pallas step (interpret mode): ids identical on >= 99.9% of pixels,
    and the summed per-block partials match its accumulator."""
    from wild_visual_navigation_tpu.ops.slic_fused import _P, _round_up, _slic_step

    H, W, K = 64, 64, 12
    rng = np.random.default_rng(7)
    image = rng.random((3, H, W), dtype=np.float32)
    ws, win2 = tslic.slic_geometry(K, 10.0, H, W)
    feats = tslic.pixel_features(tslic.rgb_to_lab(torch.from_numpy(image))[None], ws)  # (1, 5, HW)
    idx = tslic._init_index(K, H, W)
    centers = feats[:, :, idx].transpose(1, 2) + torch.from_numpy(rng.standard_normal((1, K, 5)).astype(np.float32))
    centers = centers.contiguous()
    ids, partials = tslic_fused.slic_step(feats, centers, W, ws, win2)

    HWpad = _round_up(H * W, _P)
    f_np = np.zeros((1, 8, HWpad), np.float32)
    f_np[:, :5, : H * W] = feats.numpy()
    valid = (np.arange(HWpad) < H * W).astype(np.float32).reshape(1, 1, HWpad)
    c_np = np.zeros((1, 16, 8), np.float32)
    c_np[:, :K, :5] = centers.numpy()
    acc, jids = _slic_step(f_np, valid, c_np, K=K, win2=win2, inv_ws2=float(1.0 / (ws * ws)), interpret=True)
    jids = np.asarray(jids).reshape(-1)[: H * W]
    assert np.mean(ids.numpy()[0] == jids) >= 0.999
    if np.array_equal(ids.numpy()[0], jids):
        _close(partials.sum(1)[0, :, :6], np.asarray(acc)[0, :K, :6], 1e-3, 1e-5)
    # the plain step is the whole-image form cut into 256-pixel blocks
    full = tslic._assign_plain(feats[0], centers[0], W, ws, win2)
    np.testing.assert_array_equal(ids[0].numpy(), full.numpy())
    assert partials.shape == (1, H * W // tslic_fused.PIXELS_PER_BLOCK, K, 6)


def test_slic_batch_matches_jax():
    """Four iterations at 64x64, K=12: >= 99% label agreement with the
    reference's XLA form and with its Pallas step (interpret mode)."""
    imgs = np.random.default_rng(8).random((2, 3, 64, 64), dtype=np.float32)
    got = tslic.slic_batch(torch.from_numpy(imgs), num_components=12, iterations=4).numpy()
    xla = np.asarray(jax.vmap(lambda x: jslic.slic(x, num_components=12, iterations=4))(imgs))
    pallas = np.asarray(jslic.slic_batch(imgs, num_components=12, iterations=4, impl="pallas-interpret"))
    assert got.dtype == np.int32 and got.shape == (2, 64, 64)
    assert got.min() >= 0 and got.max() < 12
    assert np.mean(got == xla) >= 0.99
    assert np.mean(got == pallas) >= 0.99
    # the plain whole-image loop agrees as well
    one = tslic.slic(torch.from_numpy(imgs[0]), num_components=12, iterations=4).numpy()
    assert np.mean(one == xla[0]) >= 0.99
