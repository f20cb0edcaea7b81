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
    and the new centres equal the means of its accumulator."""
    from wild_visual_navigation_tpu.ops.slic_fused import _P, _round_up, _slic_step

    H, W, K = 64, 64, 12
    rng = np.random.default_rng(7)
    image = rng.random((3, H, W), dtype=np.float32)
    ws, win2 = tslic.slic_geometry(K, 10.0, H, W)
    feats = tslic.pixel_features(tslic.rgb_to_lab(torch.from_numpy(image))[None], ws)  # (1, 5, HW)
    idx = tslic._init_index(K, H, W)
    centers = feats[:, :, idx].transpose(1, 2) + torch.from_numpy(rng.standard_normal((1, K, 5)).astype(np.float32))
    centers = centers.contiguous()
    ids, new_centers = tslic_fused.slic_step(feats, centers, W, ws, win2)

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
        acc = np.asarray(acc)[0, :K]
        counts = acc[:, 5:6]
        want = np.where(counts > 0, acc[:, :5] / np.maximum(counts, 1.0), centers.numpy()[0])
        _close(new_centers[0], want, 1e-4, 1e-4)
    # the plain step's ids are the whole-image assignment
    full = tslic._assign_plain(feats[0], centers[0], W, ws, win2)
    np.testing.assert_array_equal(ids[0].numpy(), full.numpy())
    assert ids.dtype == torch.int32 and new_centers.shape == (1, K, 5)


def _window_d2s(centers: torch.Tensor, H: int, W: int, ws: float, rows: slice) -> torch.Tensor:
    """The window test's d2s of `_assign_plain` for the pixels of `rows`:
    (B, len(rows) * W, K)."""
    ws_t = torch.tensor(ws, dtype=torch.float32)
    cy, cx = centers[..., 3][:, None, :] / ws_t, centers[..., 4][:, None, :] / ws_t
    y = torch.arange(H, dtype=torch.float32)[rows]
    py = y[:, None].expand(-1, W).reshape(1, -1, 1)
    px = torch.arange(W, dtype=torch.float32)[None, :].expand(len(y), -1).reshape(1, -1, 1)
    return (py * py + px * px) - 2.0 * (py * cy + px * cx) + (cy * cy + cx * cx)


def _edge_centers(rng, n: int, H: int, W: int, ws: float, win2: float) -> np.ndarray:
    """n centres each at sqrt(win2)(1 + e), |e| <= 2e-7, straight out from a
    pixel on a tile's border (up from a top row, down from a bottom row, left
    or right likewise), so that this pixel is also the point of the tile's
    box nearest to the centre: the case where the candidate rule has no
    slack but its margin. Random Lab values."""
    T = tslic_fused.TILE
    r = np.sqrt(win2) * (1 + rng.uniform(-2e-7, 2e-7, n))
    c = np.zeros((n, 5), np.float32)
    c[:, :3] = rng.normal(50, 20, (n, 3))
    for i in range(n):
        side = rng.integers(0, 4)
        py, px = float(rng.integers(0, H)), float(rng.integers(0, W))
        if side < 2:
            t0 = T * rng.integers(0, -(-H // T))
            py = float(t0) if side == 0 else float(min(t0 + T - 1, H - 1))
            py += -r[i] if side == 0 else r[i]
        else:
            t0 = T * rng.integers(0, -(-W // T))
            px = float(t0) if side == 2 else float(min(t0 + T - 1, W - 1))
            px += -r[i] if side == 2 else r[i]
        c[i, 3], c[i, 4] = py * ws, px * ws
    return c


@pytest.mark.parametrize("hw,K", [((224, 224), 100), ((61, 97), 12), ((448, 448), 100), ((448, 448), 64),
                                  ((224, 224), 512), ((48, 48), 100)])
def test_tile_candidates_never_drop_a_centre_in_the_window(hw, K):
    """K3's candidate rule keeps every centre that passes the fp32 window
    test at some pixel of its tile: for seeded random centres, for centres
    placed on the window's edge (within 2e-7 of it), and for a window
    chosen so that one pixel's d2s equals win2 exactly."""
    H, W = hw
    rng = np.random.default_rng(H * W + K)
    ws, win2 = tslic.slic_geometry(K, 10.0, H, W)
    rand = np.zeros((K, 5), np.float32)
    rand[:, 3] = rng.uniform(-0.2 * H, 1.2 * H, K) * ws
    rand[:, 4] = rng.uniform(-0.2 * W, 1.2 * W, K) * ws
    edge = _edge_centers(rng, K, H, W, ws, win2)
    centers = torch.from_numpy(np.stack([rand, edge]))  # (2, K, 5)
    # a window whose edge one pixel meets exactly: win2 = that pixel's d2s
    y, k = int(rng.integers(0, H)), int(rng.integers(0, K))
    exact = float(_window_d2s(centers[:1], H, W, ws, slice(y, y + 1))[0, int(rng.integers(0, W)), k])
    ntx = -(-W // tslic_fused.TILE)
    kept = 0
    for w2 in (win2, exact):
        cand = tslic_fused.tile_candidates_plain(centers, H, W, ws, w2)  # (2, tiles, K)
        assert cand.shape == (2, tslic_fused.num_tiles(H, W), K)
        hit_edge = 0
        for y0 in range(0, H, tslic_fused.TILE):
            rows = slice(y0, min(y0 + tslic_fused.TILE, H))
            passes = _window_d2s(centers, H, W, ws, rows) <= w2  # (2, rows * W, K)
            hit_edge += int((_window_d2s(centers, H, W, ws, rows) == w2).sum())
            tile = (torch.arange(W) // tslic_fused.TILE + (y0 // tslic_fused.TILE) * ntx).repeat(rows.stop - y0)
            assert not (passes & ~cand[:, tile]).any(), "a centre inside the window is not a candidate of its tile"
            kept += int(passes.any(1).sum())
        if w2 == exact:
            assert hit_edge >= 1  # the exact-edge pixel is among those checked
    assert kept > 0
    # the list is a small part of K where the window is small against the image
    frac = float(tslic_fused.tile_candidates_plain(centers[:1], H, W, ws, win2).float().mean())
    assert frac < (0.5 if H * W > 20000 else 1.0)


def _assign_with_candidates(feats, centers, width, ws, win2):
    """K3's assignment written in torch: the windowed argmin over each
    tile's candidates only, and the dense fallback for pixels with no
    candidate in the window."""
    B, _, HW = feats.shape
    H = HW // width
    cand = tslic_fused.tile_candidates_plain(centers, H, width, ws, win2)  # (B, tiles, K)
    out = []
    for b in range(B):
        f = [feats[b, i][:, None] for i in range(5)]
        c = [centers[b, :, i][None, :] for i in range(5)]
        d2 = tslic._sum5([fi * fi for fi in f]) - 2.0 * tslic._sum5([fi * ci for fi, ci in zip(f, c)]) \
            + tslic._sum5([ci * ci for ci in c])
        d2s = _window_d2s(centers[b : b + 1], H, width, ws, slice(0, H))[0]
        p = torch.arange(HW)
        tile = (p // width) // tslic_fused.TILE * (-(-width // tslic_fused.TILE)) + (p % width) // tslic_fused.TILE
        ok = (d2s <= win2) & cand[b][tile]
        best = torch.argmin(torch.where(ok, d2, tslic.BIG), dim=1)
        orphan = ~ok.any(1)
        out.append(torch.where(orphan, torch.argmin(d2s, dim=1), best))
    return torch.stack(out)


@pytest.mark.parametrize("hw,K", [((64, 64), 12), ((61, 97), 20), ((48, 48), 100), ((96, 112), 64)])
def test_candidate_assignment_equals_dense_assignment(hw, K):
    """The candidate-restricted assignment gives the dense ids on perturbed
    centres and when a block of centres moves away, leaving orphans."""
    H, W = hw
    rng = np.random.default_rng(9)
    ws, win2 = tslic.slic_geometry(K, 10.0, H, W)
    imgs = torch.from_numpy(rng.random((2, 3, H, W), dtype=np.float32))
    feats = tslic.pixel_features(tslic.rgb_to_lab(imgs), ws)
    centers = feats[:, :, tslic._init_index(K, H, W)].transpose(1, 2)
    centers = centers + torch.from_numpy(rng.standard_normal(centers.shape).astype(np.float32))
    centers[1, : K // 2, 3] += 3 * H * ws  # half the centres leave: their pixels become orphans
    want = torch.stack([tslic._assign_plain(feats[b], centers[b], W, ws, win2) for b in range(2)])
    got = _assign_with_candidates(feats, centers, W, ws, win2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    d2s = _window_d2s(centers[1:], H, W, ws, slice(0, H))[0]
    assert int((d2s.min(1).values > win2).sum()) > 0  # orphans met


@pytest.mark.parametrize("hw,K,want", [
    ((224, 224), 100, (7, 16, 2, 8)),
    ((448, 448), 100, (7, 16, 7, 2)),
    ((448, 448), 64, (7, 16, 7, 2)),
    ((61, 97), 12, (2, 16, 1, 8)),
    ((224, 224), 512, (7, 16, 2, 4)),
    ((48, 48), 100, (1, 9, 1, 8)),
    ((5, 7), 3, (1, 1, 1, 8)),
])
def test_slic_step_layout_follows_the_shape(hw, K, want):
    """K3's launch on an H100 (7 clusters of 16 CTAs at once): an image's
    tiles spread over the clusters the card holds, a tile over 8, 4, 2 or
    1 warps; one cluster holds a small image ("cluster"), several join
    through the global level ("cluster+ticket")."""
    lay = tslic_fused.step_layout(*hw, K, 7)
    assert (lay.clusters, lay.cluster_size, lay.tiles, lay.parts) == want
    assert lay.variant == ("cluster" if lay.clusters == 1 else "cluster+ticket")


def test_slic_step_layouts_fit_the_kernel():
    """For every shape, K and card size: the CTAs cover the image's tiles,
    no CTA has more than 16 warps or clusters more than 16 CTAs, and the
    shared memory the kernel asks for fits the H100's 227 KB."""
    rng = np.random.default_rng(11)
    shapes = [(224, 224), (448, 448), (644, 644), (61, 97), (1, 1), (16, 16), (17, 300), (1080, 1920)]
    shapes += [tuple(int(v) for v in rng.integers(1, 1200, 2)) for _ in range(40)]
    for H, W in shapes:
        for K in (1, 3, 12, 64, 100, 200, 512):
            for slots in (1, 2, 7, 8, 16):
                lay = tslic_fused.step_layout(H, W, K, slots)
                tiles = tslic_fused.num_tiles(H, W)
                assert lay.clusters * lay.cluster_size * lay.tiles >= tiles
                assert -(-tiles // (lay.clusters * lay.cluster_size)) == lay.tiles
                assert 1 <= lay.cluster_size <= tslic_fused.MAX_CLUSTER and lay.parts in (1, 2, 4, 8)
                assert lay.tiles * lay.parts <= tslic_fused.MAX_WARPS
                smem = tslic_fused._smem_floats(K, lay.tiles * lay.parts, lay.cluster_size, lay.tiles)
                assert smem <= tslic_fused.SMEM_FLOATS, (H, W, K, slots, lay)


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
