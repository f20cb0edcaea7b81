"""Parity of the port's geometry against the JAX package, on the CPU:
Lie groups, projection, convex hull, the hull fill (kernel K4's plain
version), project_and_render and the masked segment mean.

Inputs are made with numpy from fixed seeds and fed to both packages.

Masks are compared pixel for pixel. The JAX functions run jit-compiled,
and XLA's CPU compiler contracts a·b + c into fused multiply-adds where
torch's CPU ops round after every operation. So a pixel whose edge value
lies within fp32 rounding of the threshold may fall on either side.
`_knife_edge_report` allows exactly those pixels: each differing pixel's
edge value, recomputed in float64, must lie within 4 fp32 ulps of the
largest term |a·x|, |b·y|, |c| of the evaluation from the threshold (a
few 1e-3 at most, for coordinates of a few hundred pixels). The tests report how many such
pixels they met.
"""

import jax
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu.ops import projection as jproj
from wild_visual_navigation_tpu.ops import rasterize as jrast
from wild_visual_navigation_tpu.ops import segment_ops as jseg
from wild_visual_navigation_tpu.ops.rasterize_pallas import fill_hulls_pallas
from wild_visual_navigation_tpu.utils import lie as jlie
from wild_visual_navigation_tpu_torch.ops import projection as tproj
from wild_visual_navigation_tpu_torch.ops import rasterize as trast
from wild_visual_navigation_tpu_torch.ops import segment_ops as tseg
from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_edges_plain, fill_hulls, fill_hulls_plain, hull_edges
from wild_visual_navigation_tpu_torch.traversability.nodes import SupervisionNode
from wild_visual_navigation_tpu_torch.utils import lie as tlie

GEOM_ATOL = 1e-5  # lie / projection against JAX (fp32 on both sides)
EPS32 = float(np.finfo(np.float32).eps)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got: torch.Tensor, want, atol=GEOM_ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _knife_edge_report(got: np.ndarray, want: np.ndarray, hulls: np.ndarray, hull_valid: np.ndarray) -> int:
    """Number of differing pixels; raises unless each lies on a knife edge
    (see the module docstring)."""
    diff = np.argwhere(got != want)
    if diff.size == 0:
        return 0
    v0 = hulls.astype(np.float64)
    v1 = np.roll(v0, -1, axis=1)
    ex, ey = v1[..., 0] - v0[..., 0], v1[..., 1] - v0[..., 1]
    a, b, c = -ey, ex, ey * v0[..., 0] - ex * v0[..., 1]
    for bi, y, x in diff:
        assert hull_valid[bi].sum() >= 3, "a degenerate hull must fill nothing in both"
        val = a[bi] * x + b[bi] * y + c[bi]
        k = int(np.argmin(val))
        scale = max(abs(a[bi, k] * x), abs(b[bi, k] * y), abs(c[bi, k]))
        assert abs(val[k] + 1e-6) <= 4 * EPS32 * scale, (
            f"pixel {(bi, y, x)} differs but its edge value {val[k]:.3e} is not within fp32 rounding "
            f"({4 * EPS32 * scale:.1e}) of the threshold")
    return len(diff)


# ------------------------------------------------------------------- lie


@pytest.fixture(scope="module")
def tangents():
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-5  # near the identity: series branches
    axes = rng.standard_normal((8, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    xi[8:16, 3:] = (axes * (np.pi - 1e-4)).astype(np.float32)  # near pi
    return xi


def test_hat_vee_so3_exp_log_match_jax(tangents):
    phi = tangents[:, 3:]
    _close(tlie.hat(_t(phi)), jlie.hat(phi))
    _close(tlie.vee(tlie.hat(_t(phi))), jlie.vee(jlie.hat(phi)))
    R = tlie.so3_exp(_t(phi))
    jR = np.asarray(jlie.so3_exp(phi))
    _close(R, jR)
    _close(tlie.so3_log(_t(jR)), jlie.so3_log(jR))  # near pi too
    # the round trip, away from pi where the log is ill-conditioned in fp32
    away = np.r_[0:8, 16:64]
    _close(tlie.so3_exp(tlie.so3_log(R))[away], R.numpy()[away])


def test_se3_maps_match_jax(tangents):
    T = tlie.se3_exp(_t(tangents))
    jT = np.asarray(jlie.se3_exp(tangents))
    _close(T, jT)
    _close(tlie.se3_log(_t(jT)), jlie.se3_log(jT))  # the same input: near pi the log is ill-conditioned
    _close(tlie.se3_inverse(T), jlie.se3_inverse(jT))
    _close(tlie.se3_matrix(T[:, :3, :3], T[:, :3, 3]), jlie.se3_matrix(jT[:, :3, :3], jT[:, :3, 3]))
    pts = np.random.default_rng(1).standard_normal((64, 7, 3)).astype(np.float32)
    _close(tlie.transform_points(T, _t(pts)), jlie.transform_points(jT, pts))
    _close(tlie.pose_distance(T[:32], T[32:]), jlie.pose_distance(jT[:32], jT[32:]))


def test_rotation_parametrisations_match_jax():
    rng = np.random.default_rng(2)
    rpy = rng.uniform(-np.pi, np.pi, (32, 3)).astype(np.float32)
    R = tlie.so3_from_rpy(_t(rpy))
    _close(R, jlie.so3_from_rpy(rpy))
    q = rng.standard_normal((32, 4)).astype(np.float32)
    _close(tlie.quat_to_rot(_t(q)), jlie.quat_to_rot(q))
    _close(tlie.rot_to_quat(R), jlie.rot_to_quat(np.asarray(jlie.so3_from_rpy(rpy))))


def test_golden_se3_log():
    """The JAX package's golden (tests/test_product_loop.py)."""
    xi = torch.tensor([0.2, -0.6, 0.5, -0.5, 0.1, 0.4])
    T = tlie.se3_exp(xi)
    T2 = T @ tlie.se3_exp(xi * 0.1)
    out = tlie.se3_log(T2 @ torch.linalg.inv(T) @ T)
    _close(out, np.array([0.22, -0.66, 0.55, -0.55, 0.11, 0.44], np.float32), atol=2e-4)


def test_golden_projection():
    cam = tproj.Camera(K=torch.tensor([[[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]]]), height=120, width=160)
    pts = torch.tensor([[[0.3, -0.2, 2.0], [-0.5, 0.1, 4.0]]])
    p2d, valid, _ = tproj.project_points(cam, torch.eye(4)[None], pts)
    _close(p2d[0], [[95.0, 50.0], [67.5, 62.5]], atol=1e-4)
    assert bool(valid.all())


# ------------------------------------------------------------ projection


@pytest.mark.parametrize("new", [(224, None), (224, 224), (120, 200)])
@pytest.mark.parametrize("homogeneous", [False, True])
def test_scale_intrinsics_matches_jax(new, homogeneous):
    K = np.array([[[720.0, 0, 700], [0, 710.0, 540], [0, 0, 1]], [[380.0, 0, 330], [0, 385.0, 250], [0, 0, 1]]])
    if homogeneous:
        K = np.stack([np.pad(k, ((0, 1), (0, 1))) for k in K])
        K[:, 3, 3] = 1.0
    got = tproj.scale_intrinsics(K, 1080, 1440, new_h=new[0], new_w=new[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jproj.scale_intrinsics(K, 1080, 1440, *new)))
    cam, jcam = tproj.make_camera(K[0], 1080, 1440, *new), jproj.make_camera(K[0], 1080, 1440, *new)
    assert (cam.height, cam.width) == (jcam.height, jcam.width) and cam.K.shape == (1, 3, 3)


def test_scale_intrinsics_square_crop_quirk():
    K = np.array([[720.0, 0, 720, 0], [0, 720.0, 540, 0], [0, 0, 1, 0], [0, 0, 0, 1]])[None]
    sK = tproj.scale_intrinsics(K, h=1080, w=1440, new_h=224)
    s = 224 / 1080
    assert sK[0, 0, 0].item() == pytest.approx(720 * s, rel=1e-6)
    assert sK[0, 0, 2].item() == pytest.approx(540 * s, rel=1e-6)


def _downward_poses(rng, B, height=2.0, tilt=0.15):
    """Cameras above the ground looking down, with random yaw, tilt and offset."""
    rpy = np.stack([np.pi + rng.uniform(-tilt, tilt, B), rng.uniform(-tilt, tilt, B), rng.uniform(-np.pi, np.pi, B)], -1)
    R = np.asarray(jlie.so3_from_rpy(rpy.astype(np.float32)), np.float64)
    t = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B), np.full(B, height)], -1)
    T = np.tile(np.eye(4), (B, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, t
    return T.astype(np.float32)


def _footprints(rng, B, pad=64):
    """Robot footprints between consecutive supervision nodes, padded to
    `pad` points as the estimator pads them."""
    out = []
    for _ in range(B):
        yaw = rng.uniform(-np.pi, np.pi)
        poses = []
        for s in (0.0, rng.uniform(0.1, 0.6)):
            T = np.eye(4)
            T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
            T[:2, 3] = rng.uniform(-0.3, 0.3, 2) + s * np.array([np.cos(yaw), np.sin(yaw)])
            poses.append(T)
        a, b = (SupervisionNode(timestamp=float(i), pose_base_in_world=T, width=0.6, length=1.0, height=0.3,
                                twist_in_base=np.ones(3)) for i, T in enumerate(poses))
        fp = b.make_footprint_with_node(a)
        out.append(np.concatenate([fp, np.tile(fp[-1:], (pad - len(fp), 1))]))
    return np.stack(out).astype(np.float32)


CAMERAS = {(48, 64): [[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]],
           (224, 224): [[134.4, 0, 112], [0, 134.4, 112], [0, 0, 1]]}


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def scene(request):
    """B=4 downward cameras and footprints, as numpy, for both packages."""
    hw = request.param
    rng = np.random.default_rng(hw[0])
    B = 4
    K = np.tile(np.asarray(CAMERAS[hw], np.float32)[None], (B, 1, 1))
    return hw, K, _downward_poses(rng, B), _footprints(rng, B)


def test_project_points_matches_jax(scene):
    (H, W), K, poses, pts = scene
    p2d, valid, valid_z = tproj.project_points(tproj.Camera(_t(K), H, W), _t(poses), _t(pts))
    jp2d, jvalid, jvalid_z = jproj.project_points(jproj.Camera(K, H, W), poses, pts)
    # pixel coordinates of a few hundred: one fp32 ulp is up to 3e-5
    _close(p2d, jp2d, rtol=1e-6)
    np.testing.assert_array_equal(valid_z.numpy(), np.asarray(jvalid_z))
    assert (valid.numpy() != np.asarray(jvalid)).sum() <= 1  # an in-bounds test at a border pixel may round either way


# ------------------------------------------------------------ convex hull


def _hull_cases():
    rng = np.random.default_rng(3)
    cases = {"random": (rng.uniform(-5, 60, (6, 24, 2)).astype(np.float32), rng.uniform(size=(6, 24)) < 0.8)}
    pts = np.zeros((5, 12, 2), np.float32)
    valid = np.zeros((5, 12), bool)
    pts[1, :2], valid[1, :2] = [[3, 4], [10, 4]], True  # two points
    pts[2], valid[2] = np.stack([np.arange(12), 2 * np.arange(12)], -1), True  # collinear
    pts[3, :6], valid[3, :6] = [[0, 0], [8, 0], [8, 6], [0, 6], [8, 6], [4, 3]], True  # duplicate + interior
    pts[4], valid[4] = rng.uniform(0, 20, (12, 2)), True
    pts[4, 5] = np.nan  # a non-finite point is ignored
    cases["degenerate"] = (pts, valid)  # row 0: all invalid
    return cases


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_convex_hull_identical_to_jax(case):
    pts, valid = _hull_cases()[case]
    hull, hv = trast.convex_hull(_t(pts), _t(valid), max_hull=16)
    jhull, jhv = jax.vmap(lambda p, v: jrast.convex_hull(p, v, max_hull=16))(pts, valid)
    np.testing.assert_array_equal(hv.numpy(), np.asarray(jhv))
    np.testing.assert_array_equal(hull.numpy(), np.asarray(jhull))
    if case == "degenerate":
        # all invalid, two points: no hull; collinear: the two ends, which
        # fill nothing; duplicates and an interior point: the 4 corners
        assert hv.sum(-1).tolist()[:4] == [0, 0, 2, 4]
        assert int(fill_hulls_plain(hull, hv, 24, 24)[:3].sum()) == 0


def test_convex_hull_of_projected_footprints(scene):
    (H, W), K, poses, pts = scene
    p2d, _, vz = jproj.project_points(jproj.Camera(K, H, W), poses, pts)
    p2d, vz = np.asarray(p2d), np.asarray(vz)
    hull, hv = trast.convex_hull(_t(p2d), _t(vz))
    jhull, jhv = jax.vmap(lambda p, v: jrast.convex_hull(p, v))(p2d, vz)
    np.testing.assert_array_equal(hv.numpy(), np.asarray(jhv))
    np.testing.assert_array_equal(hull.numpy(), np.asarray(jhull))
    assert (hv.sum(-1) >= 4).all()  # a rectangle's corners at least


# --------------------------------------------------------- fill (K4 plain)


def _fill_cases(scene):
    """(name, hulls, hull_valid, H, W) from JAX's hulls: random point sets
    and the scene's projected footprints."""
    (H, W), K, poses, pts = scene
    rng = np.random.default_rng(H)
    rpts = (rng.uniform(size=(4, 24, 2)) * [W, H] * 1.2 - 5.0).astype(np.float32)
    rvalid = rng.uniform(size=(4, 24)) < 0.8
    p2d, _, vz = jproj.project_points(jproj.Camera(K, H, W), poses, pts)
    out = []
    for name, (p, v) in {"random": (rpts, rvalid), "footprint": (np.asarray(p2d), np.asarray(vz))}.items():
        h, hv = jax.vmap(lambda a, b: jrast.convex_hull(a, b))(p, v)
        out.append((name, np.asarray(h), np.asarray(hv), H, W))
    return out


def test_fill_hulls_plain_matches_pallas_and_scan(scene):
    for name, hulls, hv, H, W in _fill_cases(scene):
        got = fill_hulls_plain(_t(hulls), _t(hv), H, W).numpy()
        pallas = np.asarray(fill_hulls_pallas(hulls, hv, H, W, block_h=8, interpret=True))
        scan = np.asarray(jax.vmap(lambda h, v: jrast.fill_convex_hull(h, v, H, W))(hulls, hv))
        n_p = _knife_edge_report(got, pallas, hulls, hv)
        n_s = _knife_edge_report(got, scan, hulls, hv)
        print(f"{name} {H}x{W}: {got.sum()} inside; knife-edge pixels vs Pallas {n_p}, vs scan {n_s}")
        assert got.sum() > 0
        # the port's scan form and its plain K4 agree the same way
        tscan = torch.stack([trast.fill_convex_hull(_t(h), _t(v), H, W) for h, v in zip(hulls, hv)]).numpy()
        _knife_edge_report(got, tscan, hulls, hv)


def test_fill_hulls_degenerate_and_edges():
    hulls = torch.zeros((2, 8, 2))
    assert int(fill_hulls_plain(hulls, torch.zeros((2, 8), dtype=torch.bool), 16, 16).sum()) == 0
    square = torch.tensor([[[2.0, 3.0], [12.0, 3.0], [12.0, 9.0], [2.0, 9.0]]])
    ok = torch.ones((1, 4), dtype=torch.bool)
    edges = hull_edges(square, ok)
    big = float(np.float32(1e30))
    assert edges.shape == (1, 5, 3) and edges[0, 4].tolist() == [0.0, 0.0, big]
    assert hull_edges(square, torch.tensor([[True, True, False, False]]))[0, 4, 2].item() == -big
    m = fill_hulls(square, ok, 16, 20)[0]
    assert m[5, 5] and m[3, 2] and m[9, 12] and not m[0, 0] and not m[10, 13]
    assert int(m.sum()) == 11 * 7  # boundary pixels are inside
    np.testing.assert_array_equal(m.numpy(), np.asarray(fill_hulls_pallas(square.numpy(), ok.numpy(), 16, 20,
                                                                          block_h=8, interpret=True))[0])


def test_fill_hulls_nan_fills_nothing():
    """A NaN edge propagates through the minimum and leaves the pixel out,
    as jnp.minimum does in the reference."""
    hulls = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [float("nan"), 10.0], [0.0, 10.0]]])
    ok = torch.ones((1, 4), dtype=torch.bool)
    assert int(fill_hulls_plain(hulls, ok, 12, 12).sum()) == 0
    assert int(np.asarray(fill_hulls_pallas(hulls.numpy(), ok.numpy(), 12, 12, block_h=4, interpret=True)).sum()) == 0


# K4 on the card finds each row's span from per-edge thresholds (see
# csrc/fill_hulls.cu). Its premise and its span rule, in torch on the CPU.


def _edge_passes(a, b, c, H, W):
    """(E, H, W) bool: each edge's test at every pixel, in the plain fill's
    fp32 rounding ((a·x) + (b·y)) + c >= -1e-6."""
    xs = torch.arange(W, dtype=torch.float32)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32)[None, :, None]
    return a[:, None, None] * xs + b[:, None, None] * ys + c[:, None, None] >= -1e-6


def _premise_edges(kind, rng, H, W):
    """Seeded edge lines (a, b, c) of one kind, as float32 tensors."""
    n = 64
    if kind == "random":
        a, b = rng.uniform(-40, 40, n), rng.uniform(-40, 40, n)
        c = rng.uniform(-40, 40, n) * max(H, W)
    elif kind == "tiny_slopes":
        a = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-7, -3, n)
        b = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-7, 1, n)
        c = rng.uniform(-1e-3, 1e-3, n)
        a[:4] = [1e-7, -1e-7, 0.0, -0.0]
    else:  # knife edges: c puts the value at a chosen pixel on the threshold, or one ulp either side
        a, b = rng.uniform(-3, 3, n), rng.uniform(-3, 3, n)
        x0, y0 = rng.integers(0, W, n).astype(np.float32), rng.integers(0, H, n).astype(np.float32)
        s = (a.astype(np.float32) * x0 + b.astype(np.float32) * y0).astype(np.float32)
        c = (np.float32(-1e-6) - s).astype(np.float32)
        c = np.where(np.arange(n) % 3 == 1, np.nextafter(c, np.float32(np.inf)), c)
        c = np.where(np.arange(n) % 3 == 2, np.nextafter(c, np.float32(-np.inf)), c)
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    gate = np.float32(1e30)
    a, b, c = np.r_[a, 0, 0], np.r_[b, 0, 0], np.r_[c, gate, -gate]  # the gate edge, both ways
    return torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)


@pytest.mark.parametrize("kind", ["random", "tiny_slopes", "knife_edge"])
def test_k4_premise_each_edge_passes_on_a_prefix_or_a_suffix(kind):
    """Along every row, each edge's pass set is a suffix (a > 0), a prefix
    (a < 0), or all or none of the row (a = 0)."""
    H, W = 61, 97
    a, b, c = _premise_edges(kind, np.random.default_rng(7), H, W)
    p = _edge_passes(a, b, c, H, W)
    flips = (p[..., 1:] != p[..., :-1]).sum(-1)  # (E, H)
    assert int(flips.max()) <= 1
    rising = (~p[..., 0] & p[..., -1]) | (flips == 0)
    falling = (p[..., 0] & ~p[..., -1]) | (flips == 0)
    assert bool(rising[a > 0].all()) and bool(falling[a < 0].all()) and bool((flips[a == 0] == 0).all())
    if kind == "knife_edge":
        assert 0 < int(p.sum()) < p.numel()  # the thresholds fall inside the rows


def _span_fill(edges: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Test oracle of K4's fill: each edge's threshold along each row by a
    binary search over the integer x, evaluating the plain fill's own
    expression, the row's span as the intersection, and the per-pixel
    evaluation for a hull whose edges could overflow or are not finite.
    edges (B, E + 1, 3) -> (B, H, W) bool."""
    B = edges.shape[0]
    a, b, c = (edges[..., k, None] for k in range(3))  # (B, E + 1, 1)
    by = b * torch.arange(H, dtype=torch.float32)[None, None, :]  # (B, E + 1, H)

    def rises(x):  # monotone False -> True along x (x == W is True)
        xc = x.clamp(max=W - 1).float()
        p = a * xc + by + c >= -1e-6
        return torch.where(x >= W, True, torch.where(a < 0, ~p, p))

    lo = torch.zeros(by.shape, dtype=torch.long)
    hi = torch.full(by.shape, W, dtype=torch.long)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        r = rises(mid)
        hi, lo = torch.where(r, mid, hi), torch.where(r, lo, mid + 1)
    first = lo  # the first x where the edge rises, W if it never does
    start = torch.where(a < 0, 0, first).amax(1)  # (B, H)
    end = torch.where(a < 0, first - 1, W - 1).amin(1)
    xs = torch.arange(W)[None, None, :]
    spans = (xs >= start[..., None]) & (xs <= end[..., None])
    bound = (a.abs() * (W - 1) + b.abs() * (H - 1) + c.abs() < 1e38).all(1).squeeze(-1)  # (B,)
    return torch.where(bound[:, None, None], spans, fill_edges_plain(edges, H, W))


def test_span_fill_equals_the_plain_fill(scene):
    for name, hulls, hv, H, W in _fill_cases(scene):
        edges = hull_edges(_t(hulls), _t(hv))
        assert torch.equal(_span_fill(edges, H, W), fill_hulls_plain(_t(hulls), _t(hv), H, W)), name
    nan_hull = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [float("nan"), 10.0], [0.0, 10.0]],
                             [[0.0, 0.0], [5e37, 0.0], [5e37, 3e37], [0.0, 3e37]]])
    ok = torch.ones((2, 4), dtype=torch.bool)
    assert torch.equal(_span_fill(hull_edges(nan_hull, ok), 12, 12), fill_hulls_plain(nan_hull, ok, 12, 12))


def test_project_and_render_matches_jax(scene):
    (H, W), K, poses, pts = scene
    inside, p2d, valid = trast.project_and_render(tproj.Camera(_t(K), H, W), _t(poses), _t(pts))
    jin, jp2d, jvalid = jrast.project_and_render(jproj.Camera(K, H, W), poses, pts)
    jin = np.asarray(jin)
    _close(p2d, jp2d, rtol=1e-6)
    _, _, jvz = jproj.project_points(jproj.Camera(K, H, W), poses, pts)
    jh, jhv = jax.vmap(lambda a, b: jrast.convex_hull(a, b))(np.asarray(jp2d), np.asarray(jvz))
    n = _knife_edge_report(inside.numpy(), jin, np.asarray(jh), np.asarray(jhv))
    print(f"project_and_render {H}x{W}: {int(inside.sum())} inside, {n} knife-edge pixels")
    assert inside.sum() > 0 and n <= 1e-4 * jin.size


def test_project_and_render_behind_camera_is_empty():
    cam = tproj.Camera(torch.tensor([[[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]]]), 120, 160)
    pose = tlie.se3_matrix(tlie.so3_from_rpy(torch.tensor([np.pi, 0.0, 0.0])), torch.tensor([0.0, 0.0, 2.0]))[None]
    square = torch.tensor([[[0.5, 0.5, 5.0], [-0.5, 0.5, 5.0], [-0.5, -0.5, 5.0], [0.5, -0.5, 5.0]]])
    inside, _, _ = trast.project_and_render(cam, pose, square)
    assert int(inside.sum()) == 0


# ------------------------------------------------------ segment pooling

SIGNAL_ATOL = 1e-6


def test_segment_masked_mean_matches_jax():
    rng = np.random.default_rng(4)
    B, H, W, S = 3, 48, 64, 9
    values = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    valid = rng.uniform(size=(B, H, W)) < 0.3
    values[~valid] = np.inf  # the unset sentinel
    seg = rng.integers(-1, S + 2, (B, H, W)).astype(np.int32)  # out-of-range ids are ignored
    mean, mvalid = tseg.segment_masked_mean(_t(values), _t(valid), _t(seg), S)
    for b in range(B):
        jm, jv = jseg.segment_masked_mean(values[b], valid[b], seg[b], S)
        _close(mean[b], jm, atol=SIGNAL_ATOL)
        np.testing.assert_array_equal(mvalid[b].numpy(), np.asarray(jv))
    empty, ev = tseg.segment_masked_mean(_t(values[0]), torch.zeros((H, W), dtype=torch.bool), _t(seg[0]), S)
    assert float(empty.abs().sum()) == 0.0 and not ev.any()
