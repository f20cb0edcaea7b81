"""The torch port's dense colour histogram (ops/histogram.py), dense SIFT
(feature_extractor/sift.py), pyramidal Lucas-Kanade (ops/optical_flow.py)
and the facade's sift and histogram modes against the JAX package, on the
CPU, from seeded numpy inputs. Every tolerance is stated beside its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor import sift as jsift
from wild_visual_navigation_tpu.ops import histogram as jhist
from wild_visual_navigation_tpu.ops import optical_flow as jflow
from wild_visual_navigation_tpu_torch.feature_extractor import feature_extractor as tfe_mod
from wild_visual_navigation_tpu_torch.feature_extractor import sift as tsift
from wild_visual_navigation_tpu_torch.ops import histogram as thist
from wild_visual_navigation_tpu_torch.ops import optical_flow as tflow

HIST_ATOL = 1e-6
SIFT_ATOL = 1e-5
FLOW_ATOL = 1e-3  # pixels
FEAT_ATOL = 1e-5  # pooled SIFT / histogram features: summation order only


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes the
    cores, and small ops then wait tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist_image():
    """Random pixels plus the branch cases: grey (delta 0), black, red with
    g < b (hue wraps through the floor-mod), and ties max == r == g."""
    rng = np.random.default_rng(0)
    img = rng.random((3, 12, 16), dtype=np.float32)
    img[:, 0, 0] = 0.5  # grey
    img[:, 0, 1] = 0.0  # black
    img[:, 0, 2] = [0.9, 0.1, 0.3]  # red, g < b: (g - b) / delta < 0
    img[:, 0, 3] = [0.8, 0.8, 0.2]  # r == g == max
    img[:, 0, 4] = [0.7, 0.2, 0.7]  # r == b == max
    img[:, 0, 5] = [0.3, 0.6, 0.6]  # g == b == max
    img[:, 0, 6] = [1.0, 0.0, 0.0]  # saturation and value at the top bin edge
    img[:, 1, :] = np.linspace(0, 1, 16, dtype=np.float32)[None]  # a grey ramp over all value bins
    return img


def test_hsv_and_histogram_match_jax():
    img = _hist_image()
    assert thist.HIST_BINS == jhist.HIST_BINS and thist.HIST_DIM == jhist.HIST_DIM == 90
    np.testing.assert_allclose(thist.rgb_to_hsv(torch.from_numpy(img)).numpy(),
                               np.asarray(jhist.rgb_to_hsv(jnp.asarray(img))), atol=HIST_ATOL)
    got = thist.dense_color_histogram(torch.from_numpy(img)).numpy()
    want = np.asarray(jhist.dense_color_histogram(jnp.asarray(img)))
    assert got.shape == want.shape == (90, 12, 16)
    np.testing.assert_allclose(got, want, atol=HIST_ATOL)
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-6)
    hsv = thist.rgb_to_hsv(torch.from_numpy(img)).numpy()
    assert hsv[0, 0, 0] == 0.0 and hsv[0, 0, 2] > 0.9  # grey has hue 0; the wrapped red lands near 1


def _texture(shape, seed):
    """Smooth random texture with strong content at every image edge, so
    the roll's wrap-around is exercised."""
    rng = np.random.default_rng(seed)
    c, h, w = shape
    img = rng.random(shape, dtype=np.float32)
    img[:, :3, :] = rng.random((c, 3, w), dtype=np.float32) * 2.0
    img[:, :, -3:] = 0.0
    return img


@pytest.mark.parametrize("shape", [(1, 32, 32), (3, 32, 32), (1, 61, 97), (3, 61, 97)],
                         ids=["1x32", "3x32", "1x61x97", "3x61x97"])
def test_dense_sift_matches_jax(shape):
    img = _texture(shape, seed=shape[0] + shape[2])
    got = tsift.dense_sift_features(torch.from_numpy(img)).numpy()
    want = np.asarray(jsift.dense_sift_features(jnp.asarray(img)))
    assert got.shape == want.shape == (128 * shape[0], *shape[1:])
    np.testing.assert_allclose(got, want, atol=SIFT_ATOL)
    one = tsift.dense_sift_channel(torch.from_numpy(img[0])).numpy()
    np.testing.assert_allclose(one, np.asarray(jsift.dense_sift_channel(jnp.asarray(img[0]))), atol=SIFT_ATOL)


def test_sift_grid_wraps_around_the_image_edge():
    """An impulse of gradient at the left edge shows up in the descriptors
    of pixels at the right edge, as with jnp.roll (a clamped shift would
    leave them empty)."""
    img = np.zeros((1, 32, 32), np.float32)
    img[0, :, :2] = 1.0
    got = tsift.dense_sift_channel(torch.from_numpy(img[0])).numpy()
    want = np.asarray(jsift.dense_sift_channel(jnp.asarray(img[0])))
    np.testing.assert_allclose(got, want, atol=SIFT_ATOL)
    assert np.abs(got[:, :, -4:]).sum() > 0


def _smooth_pair(shift, size=(48, 64), seed=0):
    """An analytic texture and its copy moved by `shift` = (dx, dy) pixels."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    k = rng.uniform(0.15, 0.45, (6, 2))
    ph = rng.uniform(0, 2 * np.pi, 6)

    def tex(x, y):
        return sum(np.sin(k[i, 0] * x + k[i, 1] * y + ph[i]) for i in range(6)) / 6 * 0.5 + 0.5

    dx, dy = shift
    return tex(xx, yy).astype(np.float32), tex(xx - dx, yy - dy).astype(np.float32)


def _points(rng, n, h, w, margin):
    return np.stack([rng.uniform(margin, w - 1 - margin, n), rng.uniform(margin, h - 1 - margin, n)],
                    axis=-1).astype(np.float32)


def _det_margin(prev, pts, window=15):
    """Every point's finest-level structure tensor has |det| >= 1e-4, four
    orders of magnitude above the 1e-8 gate: the JAX package's own level
    function passes its gate on the image scaled by 0.1 (det scales with
    the fourth power)."""
    _, good = jflow._lk_level(jnp.asarray(prev) * 0.1, jnp.asarray(prev), jnp.asarray(pts),
                              jnp.zeros_like(jnp.asarray(pts)), window, 0)
    assert bool(np.all(np.asarray(good)))


def test_track_points_follows_a_subpixel_shift():
    prev, nxt = _smooth_pair((1.3, -0.6))
    rng = np.random.default_rng(1)
    pts = _points(rng, 40, *prev.shape, margin=10)
    pts[-2:] = [[1.0, 1.0], [62.5, 46.5]]  # near the border: may leave the image
    _det_margin(prev, pts[:-2])
    got_p, got_v = tflow.track_points(torch.from_numpy(prev), torch.from_numpy(nxt), torch.from_numpy(pts))
    want_p, want_v = jflow.track_points(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=FLOW_ATOL)
    assert got_v.numpy()[:-2].all()
    # the tracker itself (both packages alike): median error 0.02 px, worst 0.19 px on this texture
    err = np.abs((got_p.numpy() - pts)[:-2] - [1.3, -0.6])
    assert np.median(err) < 0.05 and err.max() < 0.25


@pytest.mark.parametrize("seed", [0, 1])
def test_track_points_on_random_textures(seed):
    """RGB textures (the luma path), 3 levels of odd sizes (the crop)."""
    rng = np.random.default_rng(seed + 10)
    prev = rng.random((3, 45, 71), dtype=np.float32)
    prev = (prev + np.roll(prev, 1, 1) + np.roll(prev, 1, 2)) / 3
    nxt = np.roll(prev, (1, 2), axis=(1, 2)) + 0.01 * rng.standard_normal(prev.shape).astype(np.float32)
    pts = _points(rng, 30, 45, 71, margin=9)
    _det_margin(0.299 * prev[0] + 0.587 * prev[1] + 0.114 * prev[2], pts)
    got_p, got_v = tflow.track_points(torch.from_numpy(prev), torch.from_numpy(nxt), torch.from_numpy(pts))
    want_p, want_v = jflow.track_points(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=FLOW_ATOL)


def test_dense_flow_matches_jax():
    prev, nxt = _smooth_pair((0.7, 0.4), size=(40, 56), seed=3)
    got = tflow.dense_flow(torch.from_numpy(prev), torch.from_numpy(nxt), stride=8)
    want = jflow.dense_flow(jnp.asarray(prev), jnp.asarray(nxt), stride=8)
    assert got[0].shape == (5 * 7, 2) and got[1].shape == (35, 2) and got[2].shape == (35,)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=FLOW_ATOL)


def test_downsample_crops_odd_sizes():
    x = np.random.default_rng(4).random((7, 9), dtype=np.float32)
    np.testing.assert_allclose(tflow._downsample2(torch.from_numpy(x)).numpy(),
                               np.asarray(jflow._downsample2(jnp.asarray(x))), atol=1e-7)
    assert tflow._downsample2(torch.from_numpy(x)).shape == (3, 4)


@pytest.mark.parametrize("ft", ["sift", "histogram"])
@pytest.mark.parametrize("st", ["slic", "grid", "none"])
def test_facade_modes_match_jax(ft, st):
    rng = np.random.default_rng(5)
    img = rng.random((1, 3, 8, 8), dtype=np.float32).repeat(4, 2).repeat(4, 3)
    kw = dict(segmentation_type=st, feature_type=ft, input_size=32, slic_num_components=16, cell_size=8,
              max_edges=256)
    jf = jfe_mod.FeatureExtractor(key=jax.random.PRNGKey(0), **kw)
    tf = tfe_mod.FeatureExtractor(seed=0, device="cpu", **kw)
    assert tf.feature_dim == jf.feature_dim == tfe_mod.static_feature_dim(ft) == jfe_mod.static_feature_dim(ft)
    want = jf.extract(jnp.asarray(img), return_dense_features=True)
    got = tf.extract(torch.from_numpy(img), return_dense_features=True)
    np.testing.assert_allclose(got.dense_features.numpy(), np.asarray(want.dense_features), atol=SIFT_ATOL)
    seg_t, seg_j = got.segments.numpy(), np.asarray(want.segments)
    assert np.mean(seg_t == seg_j) >= (0.99 if st == "slic" else 1.0)
    assert got.features.shape == want.features.shape
    if np.array_equal(seg_t, seg_j):
        np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=FEAT_ATOL)
        np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
        np.testing.assert_array_equal(got.center_valid.numpy(), np.asarray(want.center_valid))


@pytest.mark.parametrize("st", ["grid", "none"])
def test_quick_start_runs_sift_on_cpu(tmp_path, st):
    """The port's offline CLI in the sift mode, through the facade: its
    traversability panel is visu/'s overlay of the map it scored."""
    from PIL import Image

    from wild_visual_navigation_tpu_torch import quick_start

    quick_start.main(["--device", "cpu", "--feature_type", "sift", "--segmentation_type", st, "--max_frames", "1",
                      "--network_input_image_height", "32", "--network_input_image_width", "32",
                      "--output_folder", str(tmp_path), "--no-compute_confidence"])
    (out,) = tmp_path.glob("*_trav.png")
    panel = np.asarray(Image.open(out))
    assert panel.shape == (32, 64, 3) and panel[:, 32:].std() > 0
