"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; they skip elsewhere. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py -q
"""

import numpy as np
import pytest
import torch

import wild_visual_navigation_tpu_torch as port

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, B, H, S, dtype, layout, seed):
    """q, k, v of shape (B, H, S, 64): three contiguous tensors, or the
    strided views of one (B, S, 3, H, 64) qkv buffer as models/vit.py makes
    them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if layout == "contiguous":
        return [torch.randn((B, H, S, 64), device=cuda, generator=g).to(dtype) for _ in range(3)]
    buf = torch.randn((B, S, 3, H, 64), device=cuda, generator=g).to(dtype)
    return list(buf.permute(2, 0, 3, 1, 4).unbind(0))


@pytest.mark.parametrize("layout", ["contiguous", "qkv"])
@pytest.mark.parametrize("S", [7, 200, 785, 1025, 2117, 3137])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, B, S, layout, dtype):
    from wild_visual_navigation_tpu_torch.ops.flash_attention import bf16_atol, flash_attention, xla_attention

    H = 6
    q, k, v = _qkv(cuda, B, H, S, dtype, layout, seed=S + B)
    n = flash_attention.launches
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1 and out.dtype == dtype and out.shape == (B, H, S, 64)
    assert out.stride() == (S * H * 64, 64, H * 64, 1)  # a (B, S, H, D) buffer
    ref = xla_attention(q, k, v, 0.125).float()
    atol = bf16_atol(ref) if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


def test_flash_attention_refuses_other_head_dims_and_misaligned_views(cuda):
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 1, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_attention(q, q, q)
    odd = torch.zeros(1, 1, 16, 65, device=cuda, dtype=torch.bfloat16)[..., 1:]  # 2-byte offset base
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(odd, odd, odd)


def _slic_inputs(cuda, B, H, W, K, seed):
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_geometry

    g = torch.Generator(device=cuda).manual_seed(seed)
    ws, win2 = slic_geometry(K, 10.0, H, W)
    feats = pixel_features(rgb_to_lab(torch.rand(B, 3, H, W, device=cuda, generator=g)), ws)
    centers = feats[:, :, _init_index(K, H, W).to(cuda)].transpose(1, 2)
    centers = (centers + 0.5 * torch.randn(centers.shape, device=cuda, generator=g)).contiguous()
    return feats, centers, ws, win2


@pytest.mark.parametrize("hw,K", [((224, 224), 100), ((61, 97), 12), ((448, 448), 100)])
def test_slic_step_matches_plain(cuda, hw, K):
    from wild_visual_navigation_tpu_torch.ops.slic_fused import slic_step, slic_step_plain

    H, W = hw
    feats, centers, ws, win2 = _slic_inputs(cuda, 2, H, W, K, seed=1)
    n = slic_step.launches
    ids, new_centers = slic_step(feats, centers, W, ws, win2)
    torch.cuda.synchronize()
    assert slic_step.launches == n + 1
    want_ids, want_centers = slic_step_plain(feats, centers, W, ws, win2)
    assert torch.equal(ids, want_ids)  # identical single-step ids
    torch.testing.assert_close(new_centers, want_centers, atol=1e-3, rtol=1e-5)


def test_slic_step_orphans_repeatability_and_batch(cuda):
    """B = 4 at 224^2: in image 1 a block of centres has moved far away, so
    a patch of pixels lies outside every window (orphans); ids equal the
    plain version's, and two runs are bitwise equal in ids and centres."""
    from wild_visual_navigation_tpu_torch.ops.slic_fused import SlicScratch, slic_step, slic_step_plain

    H = W = 224
    K = 100
    feats, centers, ws, win2 = _slic_inputs(cuda, 4, H, W, K, seed=2)
    centers[1, :30, 3] += 2 * H * ws  # the top rows' centres leave the image
    ws_t = torch.tensor(ws, device=cuda)
    cy, cx = centers[1, :, 3] / ws_t, centers[1, :, 4] / ws_t
    py = torch.arange(H * W, device=cuda) // W
    px = torch.arange(H * W, device=cuda) % W
    d2s = (py[:, None] - cy[None]) ** 2 + (px[:, None] - cx[None]) ** 2
    assert int((d2s.min(1).values > win2 * 1.01).sum()) > 1000  # a patch of orphans
    want_ids, want_centers = slic_step_plain(feats, centers, W, ws, win2)
    runs = []
    for _ in range(2):
        scratch = SlicScratch.allocate(4, H, W, K, cuda)
        ids, new_centers = slic_step(feats, centers, W, ws, win2, scratch)
        runs.append((ids.clone(), new_centers.clone()))
        assert int(scratch.tickets.abs().sum()) == 0  # each launch leaves its tickets at zero
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], want_ids)
    torch.testing.assert_close(runs[0][1], want_centers, atol=1e-3, rtol=1e-5)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1].view(torch.int32), runs[1][1].view(torch.int32))  # bitwise


def test_slic_batch_runs_one_launch_per_step(cuda):
    from wild_visual_navigation_tpu_torch.ops.slic import slic_batch
    from wild_visual_navigation_tpu_torch.ops.slic_fused import slic_step

    imgs = torch.rand(2, 3, 224, 224, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    n = slic_step.launches
    seg = slic_batch(imgs)
    torch.cuda.synchronize()
    assert slic_step.launches == n + 11
    agree = float((seg.cpu() == slic_batch(imgs.cpu())).float().mean())
    assert seg.shape == (2, 224, 224) and agree >= 0.95


@pytest.mark.parametrize("patches,out", [(28, (224, 224)), (28, (23, 37)), (56, (448, 448))])
@pytest.mark.parametrize("B", [1, 4])
def test_pixelwise_score_matches_plain(cuda, B, patches, out):
    """K2 (the 256 -> 32 layer on the tensor cores) against its plain
    version: trav within 2e-3, reco within rtol 1e-3 + atol 1e-4 (the MMA
    sums in another order than the plain fp32 product)."""
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute, score_pixels, score_pixels_plain

    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}},
                    device=cuda, generator=torch.Generator().manual_seed(0))
    feat = torch.randn(B, 384, patches, patches, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    ops = fused_precompute(mlp, feat, *out)
    n = score_pixels.launches
    trav, reco = score_pixels(ops, 384)
    torch.cuda.synchronize()
    assert score_pixels.launches == n + 1 and trav.shape == reco.shape == (B, *out)
    want_t, want_r = score_pixels_plain(ops, 384)
    torch.testing.assert_close(trav, want_t, atol=2e-3, rtol=0)
    torch.testing.assert_close(reco, want_r, atol=1e-4, rtol=1e-3)


def test_frame_launches_each_kernel(cuda):
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    dino = DinoInterface(input_size=224, device=cuda, seed=0)
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}},
                    device=cuda, generator=torch.Generator().manual_seed(1))
    frame = build_fused_frame_fn(dino.vit, mlp, ConfidenceConfig(), 224)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 3, 480, 640), dtype=np.uint8)).to(cuda)
    port.reset_launch_counts()
    res = frame(confidence_init(cuda), img)
    torch.cuda.synchronize()
    assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11, "fill_hulls": 0}
    assert res.traversability.shape == (224, 224) and bool(torch.isfinite(res.traversability).all())
    assert int(res.segments.min()) >= 0 and int(res.segments.max()) < 100


def _random_hulls(device, B, E, H, W, seed):
    """Hulls of random point clouds (some with fewer than 3 valid points)."""
    from wild_visual_navigation_tpu_torch.ops.rasterize import convex_hull

    rng = np.random.default_rng(seed)
    pts = torch.from_numpy((rng.uniform(size=(B, 2 * E, 2)) * [W, H] * 1.3 - 0.15 * np.array([W, H])).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(B, 2 * E)) < 0.7)
    valid[0, 2:] = False  # a degenerate hull: two points
    hulls, hull_valid = convex_hull(pts.to(device), valid.to(device), max_hull=E)
    return hulls, hull_valid


@pytest.mark.parametrize("B,E,H,W", [(32, 32, 224, 224), (3, 16, 61, 97), (2, 64, 40, 40)])
def test_fill_hulls_matches_plain(cuda, B, E, H, W):
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls, fill_hulls_plain

    hulls, hull_valid = _random_hulls(cuda, B, E, H, W, seed=B)
    n = fill_hulls.launches
    got = fill_hulls(hulls, hull_valid, H, W)
    torch.cuda.synchronize()
    assert fill_hulls.launches == n + 1 and got.dtype == torch.bool and got.shape == (B, H, W)
    want = fill_hulls_plain(hulls, hull_valid, H, W)
    assert torch.equal(got, want)  # bit-identical masks
    assert not got[0].any() and got.any()


def test_fill_hulls_degenerate_and_nan(cuda):
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls, fill_hulls_plain

    zeros = torch.zeros((4, 8, 2), device=cuda)
    assert not fill_hulls(zeros, torch.zeros((4, 8), dtype=torch.bool, device=cuda), 16, 16).any()
    square = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]]] * 2, device=cuda)
    square[1, 2, 0] = float("nan")
    ok = torch.ones((2, 4), dtype=torch.bool, device=cuda)
    got = fill_hulls(square, ok, 12, 12)
    assert torch.equal(got, fill_hulls_plain(square.cpu(), ok.cpu(), 12, 12).to(cuda))
    assert int(got[0].sum()) == 121 and not got[1].any()
    with pytest.raises(ValueError, match="at most 64"):
        fill_hulls(torch.zeros((1, 65, 2), device=cuda), torch.ones((1, 65), dtype=torch.bool, device=cuda), 8, 8)


def _clouds(B, N, H, W, seed):
    """B point clouds of N points (numpy): random ones, and in rows 1-9
    duplicates, collinear points, two valid points, none, non-finite points,
    a lattice, one horizontal line, a tiny cloud and coordinates near 1e32
    (whose edge lines overflow, so the fill evaluates every pixel)."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(size=(B, N, 2)) * [W, H] * 1.3 - 0.15 * np.array([W, H])).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < 0.7
    pts[1, N // 2:] = pts[1, : N - N // 2]
    s = rng.uniform(size=N)
    pts[2] = np.stack([10 + s * (W - 20), 5 + s * (H - 10)], -1)
    valid[3, 2:] = False
    valid[4] = False
    pts[5, ::3] = np.nan
    pts[5, 1::7, 0] = np.inf
    pts[6] = np.round(pts[6] / 20) * 20
    pts[7, :, 1] = 17.0
    pts[8] = pts[8] * 0.02 + 30.0
    pts[9] *= 1e30
    return pts, valid


@pytest.mark.parametrize("hw", [(224, 224), (61, 97)])
@pytest.mark.parametrize("max_hull,N", [(16, 64), (32, 64), (64, 64), (32, 7), (64, 256)])
def test_hull_fill_matches_convex_hull_and_plain_fill(cuda, max_hull, N, hw):
    """K4 from points: one launch gives the hull bitwise equal to
    convex_hull on the same CUDA tensors and masks identical to the plain
    fill of that hull."""
    from wild_visual_navigation_tpu_torch.ops.rasterize import convex_hull, rasterize_points_hull
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls, fill_hulls_plain, hull_fill

    H, W = hw
    pts, valid = (torch.from_numpy(a).to(cuda) for a in _clouds(12, N, H, W, seed=max_hull + N))
    n = fill_hulls.launches
    masks, hulls, hull_valid = hull_fill(pts, valid, H, W, max_hull)
    torch.cuda.synchronize()
    assert fill_hulls.launches == n + 1 and masks.shape == (12, H, W) and hulls.shape == (12, max_hull, 2)
    want_h, want_v = convex_hull(pts, valid, max_hull=max_hull)
    assert torch.equal(hull_valid, want_v)
    assert torch.equal(hulls.view(torch.int32), want_h.view(torch.int32))  # bitwise, NaN payloads included
    assert torch.equal(masks, fill_hulls_plain(want_h, want_v, H, W))
    assert torch.equal(rasterize_points_hull(pts, valid, H, W, max_hull), masks)
    assert masks[0].any() and not masks[3].any() and not masks[4].any()


def test_hull_fill_refuses_what_the_kernel_does_not_take(cuda):
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import hull_fill

    with pytest.raises(ValueError, match="1 to 256 points"):
        hull_fill(torch.zeros((1, 257, 2), device=cuda), torch.ones((1, 257), dtype=torch.bool, device=cuda), 8, 8)
    with pytest.raises(ValueError, match="max_hull of 1 to 64"):
        hull_fill(torch.zeros((1, 8, 2), device=cuda), torch.ones((1, 8), dtype=torch.bool, device=cuda), 8, 8, 65)


def test_estimator_flush_launches_fill_hulls_once(cuda, monkeypatch):
    """One K4 launch per flush runs the hull and the fill: the torch gift
    wrap is never called on the card."""
    from wild_visual_navigation_tpu_torch.ops import rasterize
    from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator

    def no_torch_hull(*args, **kwargs):
        raise AssertionError("convex_hull ran on the flush path")

    monkeypatch.setattr(rasterize, "convex_hull", no_torch_hull)
    from wild_visual_navigation_tpu_torch.traversability.nodes import MissionNode, SupervisionNode

    est = TraversabilityEstimator(
        {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 16, "hidden_sizes": [32, 1], "reconstruction": True}},
        image_distance_thr=0.1, supervision_distance_thr=0.05, buffer_capacity=16, num_segments=9, feature_dim=16,
        image_height=48, image_width=64, reprojection_fanout=8, device=cuda)

    def pose(x, z=0.0):
        T = np.eye(4)
        T[:3, 3] = [x, 0.0, z]
        return T

    cam = pose(0.0, 2.0)
    cam[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    seg = torch.arange(9, dtype=torch.int32, device=cuda).reshape(3, 3).repeat_interleave(16, 0).repeat_interleave(22, 1)
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    est.add_mission_node(MissionNode(timestamp=0.0, pose_cam_in_base=cam), torch.randn(9, 16, device=cuda),
                         torch.ones(9, dtype=torch.bool, device=cuda), seg[:48, :64], K)

    def state(t, x):
        return SupervisionNode(timestamp=t, pose_base_in_world=pose(x), width=0.4, length=0.4, height=0.3,
                               twist_in_base=np.array([1.0, 0, 0]), traversability=0.7)

    assert not est.add_supervision_node(state(0.0, -0.1))  # the first node has no footprint yet
    port.reset_launch_counts()
    assert est.add_supervision_node(state(0.1, 0.1))
    torch.cuda.synchronize()
    assert port.launch_counts()["fill_hulls"] == 1
    assert est.get_num_valid_nodes() == 1
    sig = est.buffer.signal[0][est.buffer.signal_valid[0]]
    assert sig.numel() > 0 and torch.allclose(sig, torch.tensor(0.7, device=cuda))


def test_facade_extraction_on_the_card_launches_slic_step(cuda):
    """The FeatureExtractor facade segments a CUDA image with K3 (through
    slic_batch), never with the plain loop, and runs K1 in every block."""
    from wild_visual_navigation_tpu_torch.feature_extractor.feature_extractor import FeatureExtractor

    fe = FeatureExtractor(seed=0, segmentation_type="slic", feature_type="dino", input_size=224, device=cuda)
    img = torch.rand((1, 3, 224, 224), device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    port.reset_launch_counts()
    ex = fe.extract(img, return_dense_features=True)
    torch.cuda.synchronize()
    assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0}
    assert ex.segments.device.type == "cuda" and ex.features.shape == (100, 384)
    assert int(ex.segments.min()) >= 0 and int(ex.segments.max()) < 100
    cpu = FeatureExtractor(seed=0, segmentation_type="slic", feature_type="dino", input_size=224, device="cpu")
    agree = float((cpu.compute_segments(img.cpu())[2] == ex.segments.cpu()).float().mean())
    assert agree >= 0.95


def test_runtime_callbacks_launch_each_kernel(cuda):
    """WVNRuntime on the card at the product's settings: each accepted
    frame launches K1 12, K2 1 and K3 11 times, each supervision flush K4
    once, a learning step none; the mailbox head scores the frame."""
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    fe = FeatureExtractorNodeParams(image_callback_rate=1e9)
    ln = LearningNodeParams(supervision_callback_rate=1e9, min_samples_for_training=0)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, seed=0, device=cuda)
    seq = np.load(__import__("pathlib").Path(__file__).resolve().parent.parent / "assets/sequences/demo_mission.npz")
    per_frame = {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11, "fill_hulls": 0}
    flushes = 0
    for i in range(6):
        port.reset_launch_counts()
        res = rt.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i],
                                64, 64, seq["frame_pose"][i], seq["frame_cam_in_base"][i])
        torch.cuda.synchronize()
        assert port.launch_counts() == per_frame
        trav, conf = res.to_numpy()
        assert trav.shape == (224, 224) and np.isfinite(trav).all() and np.isfinite(conf).all()
        port.reset_launch_counts()
        flushed = rt.robot_state_callback(float(seq["state_stamps"][i]), seq["state_pose"][i], seq["state_twist"][i],
                                          seq["state_desired"][i])
        torch.cuda.synchronize()
        assert port.launch_counts()["fill_hulls"] == int(flushed)
        flushes += int(flushed)
        port.reset_launch_counts()
        rt.learning_step()
        torch.cuda.synchronize()
        assert sum(port.launch_counts().values()) == 0
    assert flushes > 0 and rt.estimator.step > 0
    batch = rt.image_batch_callback(seq["frame_images"][6:10], seq["frame_stamps"][6:10], ["front"] * 4,
                                    seq["frame_K"][6:10], 64, 64, seq["frame_pose"][6:10], seq["frame_cam_in_base"][6:10])
    assert len(batch) == 4 and batch[3].traversability.shape == (224, 224)


# ---------------------------------------------------------------- STEGO

# SLIC at 448^2, 10 iterations: the least label agreement of the card's
# slic_batch (K3's per-tile sums) with the plain whole-image loop. The
# card's first reading (chip_smoke.py, NVIDIA H100 80GB HBM3): 0.9998 on a
# random image, 0.9998 to 1.0 on four demo frames.
SLIC_448_MIN = 0.99


@pytest.mark.parametrize("layout", ["contiguous", "qkv"])
@pytest.mark.parametrize("B,S", [(1, 785), (4, 785), (1, 3137)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_at_vit_b8(cuda, B, S, layout, dtype):
    """K1 at ViT-B/8's 12 heads: 785 tokens at 224 (B = 1 and 4), 3137 at
    448, whose last kv tile holds one token. bf16 is held to bf16_atol,
    2**-6 of the largest |output| (the card's readings in chip_smoke.py:
    one or two bf16 units, 9.8e-4 at S = 3137 and 3.9e-3 at 785), which
    the plain version without the last kv tile exceeds."""
    from wild_visual_navigation_tpu_torch.ops.flash_attention import bf16_atol, flash_attention, xla_attention

    q, k, v = _qkv(cuda, B, 12, S, dtype, layout, seed=S + 7 * B)
    n = flash_attention.launches
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1 and out.shape == (B, 12, S, 64)
    ref = xla_attention(q, k, v, 0.125).float()
    atol = bf16_atol(ref) if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)
    keep = (S - 1) // 64 * 64
    assert float((xla_attention(q, k[:, :, :keep], v[:, :, :keep], 0.125).float() - ref).abs().max()) > atol


def _stego_head(cuda):
    from wild_visual_navigation_tpu_torch.models.registry import get_model

    return get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 90, "hidden_sizes": [256, 32, 1],
                                                              "reconstruction": True}},
                     device=cuda, generator=torch.Generator().manual_seed(1)).eval().requires_grad_(False)


@pytest.mark.parametrize("patches,size", [(28, 224), (56, 448)])
@pytest.mark.parametrize("B", [1, 4])
def test_pixelwise_score_matches_plain_with_the_stego_head(cuda, B, patches, size):
    """K2 with D = 90, the [90 -> 256 -> 32 -> 91] head of the STEGO frame,
    at the tolerances of the 384-d test."""
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute, score_pixels, score_pixels_plain

    feat = torch.randn(B, 90, patches, patches, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    ops = fused_precompute(_stego_head(cuda), feat, size, size)
    n = score_pixels.launches
    trav, reco = score_pixels(ops, 90)
    torch.cuda.synchronize()
    assert score_pixels.launches == n + 1 and trav.shape == (B, size, size)
    want_t, want_r = score_pixels_plain(ops, 90)
    torch.testing.assert_close(trav, want_t, atol=2e-3, rtol=0)
    torch.testing.assert_close(reco, want_r, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("per_pixel", [True, False], ids=["per-pixel", "per-segment"])
def test_stego_frame_launches_and_matches_the_plain_tail(cuda, per_pixel):
    """The fused STEGO frame at 224 (ViT-B/8, 20 clusters): K1 12 times, K2
    once per pixel-scored frame and never per segment, K3 never; its maps,
    segments and pooled codes against the CPU tail (plain K2, k-means on the
    CPU) fed the card's codes."""
    from wild_visual_navigation_tpu_torch.feature_extractor.stego import StegoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_stego_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    si = StegoInterface(input_size=224, device=cuda, seed=0)
    head = _stego_head(cuda)
    frame = build_fused_stego_frame_fn(si, head, ConfidenceConfig(), 224, prediction_per_pixel=per_pixel)
    img = torch.rand((1, 3, 224, 224), device=cuda, generator=torch.Generator(device=cuda).manual_seed(4))
    cg = confidence_init(cuda)
    port.reset_launch_counts()
    res = frame(cg, img)
    torch.cuda.synchronize()
    assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": int(per_pixel), "slic_step": 0,
                                    "fill_hulls": 0}
    assert res.segments.shape == (224, 224) and int(res.segments.max()) < 20 and res.features.shape == (20, 90)
    with torch.no_grad():
        codes = si.head(si.vit(imagenet_normalize(resize_image(img, 224, 224)))["patch_tokens"])["code"]
    head_cpu = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 90, "hidden_sizes": [256, 32, 1],
                                                                  "reconstruction": True}})
    head_cpu.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
    tail = build_fused_stego_frame_fn(si, head_cpu, ConfidenceConfig(), 224, prediction_per_pixel=per_pixel).tail
    ref = tail(confidence_init(), codes.cpu())
    assert float((res.segments.cpu() == ref.segments[0]).float().mean()) >= 0.99
    assert float((res.traversability.cpu() - ref.traversability[0]).abs().mean()) <= 1e-3
    assert float((res.confidence.cpu() - ref.confidence[0]).abs().mean()) <= 1e-3


def test_slic_at_448_agrees_with_the_plain_loop(cuda):
    """slic_batch at 448^2 (10 iterations, K3's per-tile sums) against the
    plain whole-image loop on the same image; the two orders move boundary
    pixels, so the agreement is held to SLIC_448_MIN."""
    from wild_visual_navigation_tpu_torch.ops.slic import slic_batch

    img = torch.rand(1, 3, 448, 448, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
    seg = slic_batch(img)
    torch.cuda.synchronize()
    assert float((seg.cpu() == slic_batch(img.cpu())).float().mean()) >= SLIC_448_MIN


def test_jackal_runtime_callbacks_launch_each_kernel(cuda):
    """WVNRuntime in the Jackal robot's profile (stego x stego at 224): each
    accepted frame launches K1 12 times, K2 once and K3 never; each flush K4
    once; a learning step nothing."""
    import dataclasses
    from pathlib import Path

    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
    from wild_visual_navigation_tpu_torch.utils.loading import load_node_params

    root = Path(__file__).resolve().parent.parent
    fe, ln = load_node_params(str(root / "configs/default.yaml"), str(root / "configs/robots/jackal.yaml"))
    fe = dataclasses.replace(fe, image_callback_rate=1e9)
    ln = dataclasses.replace(ln, supervision_callback_rate=1e9, min_samples_for_training=0)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, seed=0, device=cuda)
    seq = np.load(root / "assets/sequences/demo_mission.npz")
    flushes = 0
    for i in range(6):
        port.reset_launch_counts()
        res = rt.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i],
                                64, 64, seq["frame_pose"][i], seq["frame_cam_in_base"][i])
        torch.cuda.synchronize()
        assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 0, "fill_hulls": 0}
        trav, conf = res.to_numpy()
        assert trav.shape == (224, 224) and np.isfinite(trav).all() and np.isfinite(conf).all()
        port.reset_launch_counts()
        flushed = rt.robot_state_callback(float(seq["state_stamps"][i]), seq["state_pose"][i], seq["state_twist"][i],
                                          seq["state_desired"][i])
        torch.cuda.synchronize()
        assert port.launch_counts()["fill_hulls"] == int(flushed)
        flushes += int(flushed)
        port.reset_launch_counts()
        rt.learning_step()
        torch.cuda.synchronize()
        assert sum(port.launch_counts().values()) == 0
    assert flushes > 0 and rt.estimator.step > 0


def test_sift_histogram_and_lk_on_the_card_match_the_cpu(cuda):
    """Dense SIFT, the colour histogram and pyramidal LK (plain PyTorch, no
    kernel of their own) on a 224-px image on the card against the same
    functions on the CPU: SIFT within 1e-4, the histogram within 1e-5, LK
    positions within 1e-3 px with the same validity."""
    from wild_visual_navigation_tpu_torch.feature_extractor.sift import dense_sift_features
    from wild_visual_navigation_tpu_torch.ops.histogram import dense_color_histogram
    from wild_visual_navigation_tpu_torch.ops.optical_flow import track_points

    rng = np.random.default_rng(8)
    img = rng.random((3, 28, 28), dtype=np.float32).repeat(8, 1).repeat(8, 2)
    img = np.clip(img + 0.05 * rng.standard_normal(img.shape).astype(np.float32), 0, 1)
    x = torch.from_numpy(img)
    port.reset_launch_counts()
    for fn, tol in ((dense_sift_features, 1e-4), (dense_color_histogram, 1e-5)):
        got = fn(x.to(cuda)).cpu()
        torch.testing.assert_close(got, fn(x), atol=tol, rtol=0)
    nxt = torch.roll(x, (1, 2), dims=(1, 2))
    pts = torch.from_numpy(rng.uniform(20, 200, (256, 2)).astype(np.float32))
    p_card, v_card = track_points(x.to(cuda), nxt.to(cuda), pts.to(cuda))
    p_cpu, v_cpu = track_points(x, nxt, pts)
    assert torch.equal(v_card.cpu(), v_cpu) and bool(v_cpu.float().mean() > 0.9)
    torch.testing.assert_close(p_card.cpu(), p_cpu, atol=1e-3, rtol=0)
    assert sum(port.launch_counts().values()) == 0


def _nll_state(head, rows, device):
    """A confidence state at the scale of the anomaly head's negative
    log-likelihood on `rows`."""
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import confidence_init

    with torch.no_grad():
        out = head(rows)
        nll = -(out["logprob"].sum(-1) + out["log_det"])
    return confidence_init(device)._replace(mean=nll.mean(), std=nll.std())


@pytest.mark.parametrize("kind", ["anomaly", "graph"])
def test_anomaly_and_graph_frames_launch_and_match_the_cpu_tail(cuda, kind):
    """The DINO frame at 224 (ViT-S/8, SLIC 100) with the default LinearRnvp
    scored per pixel, or a SimpleGCN [256, 128, 1] scored per segment: K1 12
    times, K3 11 times, K2 never; maps within 1e-3 MAE of the CPU tail fed
    the card's features and segments."""
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.models.vit import dense_features
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    dino = DinoInterface(input_size=224, device=cuda, seed=0)
    cfg = ({"name": "LinearRnvp", "linear_rnvp_cfg": {"input_size": 384}} if kind == "anomaly" else
           {"name": "SimpleGCN", "simple_gcn_cfg": {"input_size": 384, "hidden_sizes": [256, 128, 1]}})
    head = get_model(cfg, device=cuda, generator=torch.Generator().manual_seed(2)).eval()
    anomaly = kind == "anomaly"
    frame = build_fused_frame_fn(dino.vit, head, ConfidenceConfig(), 224, anomaly=anomaly,
                                 prediction_per_pixel=anomaly)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 3, 224, 224), dtype=np.uint8)).to(cuda)
    with torch.no_grad():
        feat = dense_features(dino.vit, imagenet_normalize(resize_image(img.float() / 255.0, 224, 224)))
    cg = _nll_state(head, feat[0].reshape(384, -1).T, cuda) if anomaly else confidence_init(cuda)
    port.reset_launch_counts()
    res = frame(cg, img)
    torch.cuda.synchronize()
    assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0}
    head_cpu = get_model(cfg).eval()
    head_cpu.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
    tail = build_fused_frame_fn(dino.vit, head_cpu, ConfidenceConfig(), 224, anomaly=anomaly,
                                prediction_per_pixel=anomaly).tail
    ref = tail(type(cg)(*(t.cpu() for t in cg)), feat.cpu(), res.segments[None].cpu())
    for name in ("traversability", "confidence"):
        got = getattr(res, name)
        assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0 and float(got.max()) <= 1
        assert float((got.cpu() - getattr(ref, name)[0]).abs().mean()) <= 1e-3
    assert float(res.traversability.std()) > 0


def test_anomaly_runtime_callbacks_launch_each_kernel(cuda):
    """WVNRuntime(anomaly_detection=True) at the product's settings (ViT-S/8
    at 224, SLIC 100, LinearRnvp [200] x 2 flows, per pixel): each accepted
    frame launches K1 12 times, K3 11 times and K2 never; each flush K4
    once; the anomaly head trains."""
    from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    from pathlib import Path

    exp = ExperimentParams()
    exp.model.name = "LinearRnvp"
    rt = WVNRuntime(fe_params=FeatureExtractorNodeParams(image_callback_rate=1e9),
                    ln_params=LearningNodeParams(supervision_callback_rate=1e9, min_samples_for_training=0),
                    exp_params=exp, seed=0, anomaly_detection=True, device=cuda)
    seq = np.load(Path(__file__).resolve().parent.parent / "assets/sequences/demo_mission.npz")
    flushes = 0
    for i in range(8):
        port.reset_launch_counts()
        res = rt.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i],
                                64, 64, seq["frame_pose"][i], seq["frame_cam_in_base"][i])
        torch.cuda.synchronize()
        assert port.launch_counts() == {"flash_attention": 12, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0}
        trav, conf = res.to_numpy()
        assert trav.shape == (224, 224) and np.isfinite(trav).all() and (conf == 1).all()
        port.reset_launch_counts()
        flushed = rt.robot_state_callback(float(seq["state_stamps"][i]), seq["state_pose"][i], seq["state_twist"][i],
                                          seq["state_desired"][i])
        torch.cuda.synchronize()
        assert port.launch_counts()["fill_hulls"] == int(flushed)
        flushes += int(flushed)
        rt.learning_step()
    assert flushes > 0 and rt.estimator.step > 0 and np.isfinite(rt.estimator.loss)


def test_golden_replay_on_the_card(cuda):
    """The demo golden replay (sift on a 64-px grid) on the card meets the
    golden's own limits, with K4 launched once per flush."""
    from wild_visual_navigation_tpu_torch.runtime.demo_golden import replay_against_golden

    port.reset_launch_counts()
    out = replay_against_golden(cuda)
    torch.cuda.synchronize()
    counts = port.launch_counts()
    assert out["ok"], out
    assert counts["fill_hulls"] == out["flushes"] > 0
    assert counts["flash_attention"] == counts["slic_step"] == counts["pixelwise_score"] == 0


# ---------------------------------------------------------------- torchvision and the grid map

# the CNN pyramids at 448 in bf16 against the same weights in fp32 (TF32 off),
# each level's max abs error over its largest |value| (the CPU's reading at 128
# px: 4.7e-3 to 1.25e-2, some 3 bf16 units; chip_smoke.py holds the same 3e-2)
PYRAMID_BF16_REL = 3e-2


@pytest.mark.parametrize("model_type", ["resnet18", "resnet50", "efficientnet_b4"])
def test_pyramid_bf16_against_fp32_on_the_card(cuda, model_type):
    from wild_visual_navigation_tpu_torch.feature_extractor.torchvision_interface import TorchVisionInterface

    fp32 = TorchVisionInterface(model_type, device=cuda, dtype=torch.float32, seed=0)
    bf16 = TorchVisionInterface(model_type, device=cuda, params=fp32.params)
    x = torch.rand((2, 3, 448, 448), device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    want, got = fp32.inference(x), bf16.inference(x)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        assert float((got[k] - w).abs().max()) <= PYRAMID_BF16_REL * float(w.abs().max()), k


def test_torchvision_frame_launches_and_matches_the_cpu_tail(cuda):
    """The fused torchvision frame (ResNet-18 at 224, SLIC 100): K3 11
    launches at B=1 and at B=4, nothing else; the maps within 1e-5 MAE of the
    CPU tail fed the card's pyramid and segmentation."""
    from wild_visual_navigation_tpu_torch.feature_extractor.torchvision_interface import TorchVisionInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.ops.slic import slic_batch
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_torchvision_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    tvi = TorchVisionInterface("resnet18", input_size=224, device=cuda, seed=0)
    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 960, "hidden_sizes": [256, 32, 1],
                                                   "reconstruction": True}}
    head = get_model(cfg, device=cuda, generator=torch.Generator().manual_seed(2)).eval()
    cg = confidence_init(cuda)._replace(mean=torch.tensor(1.0, device=cuda), std=torch.tensor(0.5, device=cuda))
    frame = build_fused_torchvision_frame_fn(tvi, head, ConfidenceConfig(), 224)
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 3, 240, 320), dtype=np.uint8)).to(cuda)
    for B in (1, 4):
        port.reset_launch_counts()
        res = frame.frames_batch(cg, imgs[:B])
        torch.cuda.synchronize()
        assert port.launch_counts() == {"flash_attention": 0, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0}
        assert res.traversability.shape == (B, 224, 224) and res.features.shape == (B, 100, 960)
    with torch.no_grad():
        x = resize_image(imgs.float() / 255.0, 224, 224)
        pyr, segs = tvi.model(imagenet_normalize(x)), slic_batch(x)
    got = frame.tail(cg, pyr, segs)
    head_cpu = get_model(cfg).eval()
    head_cpu.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
    ref = build_fused_torchvision_frame_fn(tvi, head_cpu, ConfidenceConfig(), 224).tail(
        type(cg)(*(t.cpu() for t in cg)), {k: v.cpu() for k, v in pyr.items()}, segs.cpu())
    for name in ("traversability", "confidence"):
        m = getattr(got, name)
        assert bool(torch.isfinite(m).all()) and float(m.min()) >= 0 and float(m.max()) <= 1
        assert float((m.cpu() - getattr(ref, name)).abs().mean()) <= 1e-5


def _tv_runtime(cuda, gridmap_size=128):
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    fe = FeatureExtractorNodeParams(image_callback_rate=1e9, feature_type="torchvision")
    ln = LearningNodeParams(supervision_callback_rate=1e9, min_samples_for_training=0)
    return WVNRuntime(fe_params=fe, ln_params=ln, seed=0, device=cuda, gridmap_size=gridmap_size,
                      gridmap_resolution=0.15)


def test_torchvision_runtime_callbacks_launch_each_kernel(cuda):
    """WVNRuntime in torchvision x slic mode at the product's settings with a
    128 x 0.15 m grid map: each accepted frame launches K3 11 times and
    nothing else, each flush K4 once; the grid map fills on the card and
    yields a carrot."""
    from pathlib import Path

    rt = _tv_runtime(cuda)
    assert rt._fused_frame is not None and rt.gridmap.weight.is_cuda
    seq = np.load(Path(__file__).resolve().parent.parent / "assets/sequences/demo_mission.npz")
    flushes = 0
    for i in range(8):
        port.reset_launch_counts()
        res = rt.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i],
                                64, 64, seq["frame_pose"][i], seq["frame_cam_in_base"][i])
        torch.cuda.synchronize()
        assert port.launch_counts() == {"flash_attention": 0, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0}
        trav, conf = res.to_numpy()
        assert trav.shape == (224, 224) and np.isfinite(trav).all() and np.isfinite(conf).all()
        port.reset_launch_counts()
        flushed = rt.robot_state_callback(float(seq["state_stamps"][i]), seq["state_pose"][i], seq["state_twist"][i],
                                          seq["state_desired"][i])
        torch.cuda.synchronize()
        assert port.launch_counts()["fill_hulls"] == int(flushed)
        flushes += int(flushed)
        rt.learning_step()
    assert flushes > 0 and rt.estimator.step > 0
    assert int(rt.gridmap.valid.sum()) > 100
    goal, score = rt.get_carrot(yaw=0.0)
    assert score.shape == (128, 128) and (goal is None or np.isfinite(goal).all())


def test_gridmap_on_the_card_matches_the_cpu(cuda):
    """Recentre and fuse on the card and on the CPU from the same maps: the
    same origins, the same cells valid (a ray on a cell edge may move, none
    expected), sums within 1e-5 (the card's scatter adds with atomics in no
    fixed order); the SDF of one grid is the same bit for bit on both."""
    from wild_visual_navigation_tpu_torch.ops import gridmap as tg

    rng = np.random.default_rng(0)
    K = torch.tensor([[60.0, 0, 112], [0, 60.0, 112], [0, 0, 1]])
    grids = {d: tg.gridmap_init(128, 0.15, device=d) for d in ("cpu", cuda)}
    for step in range(6):
        a = np.deg2rad(30.0 + 5 * step)
        z, x = np.array([np.cos(a), 0.0, -np.sin(a)]), np.array([0.0, -1.0, 0.0])
        pose = np.eye(4)
        pose[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        pose[:3, 3] = [0.3 * step, 0.1 * step, 1.2]
        trav, conf = (torch.from_numpy(rng.random((224, 224), dtype=np.float32)) for _ in range(2))
        for d in grids:
            g = tg.gridmap_recenter(grids[d], pose[:2, 3])
            grids[d] = tg.project_traversability_to_grid(g, trav.to(d), K.to(d), pose, confidence=conf.to(d))
    c, k = grids["cpu"], grids[cuda]
    np.testing.assert_array_equal(k.origin_xy, c.origin_xy)
    assert int((k.valid.cpu() != c.valid).sum()) <= 2 and int(c.valid.sum()) > 1000
    both = k.valid.cpu() & c.valid
    torch.testing.assert_close(k.value_sum.cpu()[both], c.value_sum[both], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.weight.cpu()[both], c.weight[both], rtol=1e-5, atol=1e-5)
    sdf_k = tg.traversability_sdf(k.traversability, k.valid, resolution=0.15).cpu()
    sdf_c = tg.traversability_sdf(k.traversability.cpu(), k.valid.cpu(), resolution=0.15)
    assert torch.equal(sdf_k, sdf_c)


def test_obstacle_scenario_on_the_card(cuda):
    """The JAX package's closed-loop obstacle scenario on the card, held to
    that test's checks; it launches K4 (flushes) and no other kernel."""
    from wild_visual_navigation_tpu_torch.runtime.obstacle_scenario import build_runtime, run_obstacle_scenario

    port.reset_launch_counts()
    out = run_obstacle_scenario(build_runtime(cuda))
    torch.cuda.synchronize()
    counts = port.launch_counts()
    assert all(out["checks"].values()), out
    assert counts["fill_hulls"] > 0 and counts["flash_attention"] == counts["slic_step"] == 0


def _offline_data(n=24, S=8, D=16, seed=0):
    """A separable export-shaped (train, val) pair."""
    from wild_visual_navigation_tpu_torch.offline import GraphTravDataset

    rng = np.random.RandomState(seed)
    w = rng.randn(D)
    x = rng.randn(2 * n, S, D).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    yv, sv = rng.rand(2 * n, S) < 0.7, np.ones((2 * n, S), bool)

    def sub(sl):
        return GraphTravDataset(features=x[sl], signal=y[sl], signal_valid=yv[sl], sample_valid=sv[sl])

    return sub(slice(0, n)), sub(slice(n, 2 * n))


def test_offline_trainer_on_the_card_matches_the_cpu(cuda):
    """The same trainer, head and batches on both devices: per-epoch losses
    within rtol 1e-3 and scores within 1e-4 (cuBLAS sums in another order,
    TF32 off)."""
    from wild_visual_navigation_tpu_torch.offline import OfflineTrainer, OfflineTrainerConfig

    train, val = _offline_data()
    cfg = OfflineTrainerConfig(epochs=6, batch_size=4)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = 16
    card, cpu = OfflineTrainer(cfg), OfflineTrainer(cfg, device="cpu")
    assert card.device.type == "cuda"
    rc, rp = card.fit(train, val), cpu.fit(train, val)
    np.testing.assert_allclose([h["train_loss"] for h in card.history], [h["train_loss"] for h in cpu.history],
                               rtol=1e-3)
    np.testing.assert_allclose(card.predict(val.features), cpu.predict(val.features), atol=1e-4)
    assert abs(rc["val_auroc"] - rp["val_auroc"]) < 1e-2
    assert all(t.device.type == "cuda" for t in card.cg_state)


def test_population_trial0_matches_the_offline_trainer_on_the_card(cuda):
    """population_fit on the card: trial 0 against OfflineTrainer on the card
    within the JAX test's rtol 2e-3 / atol 2e-4 (a batched GEMM against
    single ones)."""
    from wild_visual_navigation_tpu_torch.offline import OfflineTrainer, OfflineTrainerConfig
    from wild_visual_navigation_tpu_torch.tools.param_search import evaluate_population, population_fit, sample_space

    train, val = _offline_data(D=32, seed=3)
    lr, wt, wr = sample_space(16, seed=42)
    scores, losses, params = population_fit(train, val, lr, wt, wr, epochs=5, batch_size=4, seed=42)
    assert all(p.device.type == "cuda" for p in params.values()) and np.isfinite(losses).all()
    cfg = OfflineTrainerConfig(epochs=5, batch_size=4, seed=42)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = 32
    trainer = OfflineTrainer(cfg)
    trainer.fit(train)
    np.testing.assert_allclose(scores[0], trainer.predict(val.features), rtol=2e-3, atol=2e-4)
    aurocs = [m["val_auroc"] for m in evaluate_population(scores, val)]
    assert max(aurocs) >= aurocs[0]


def test_soak_on_the_card_passes_every_gate(cuda):
    """200 frames at 224 px on 2 cameras (dinov2 x slic 64, per-pixel
    scoring), windows of 50: every gate holds and every kernel launches."""
    from wild_visual_navigation_tpu_torch.tools import soak

    args = soak.build_parser().parse_args(["--frames", "200", "--size", "224", "--window", "50",
                                           "--warmup_windows", "1"])
    r = soak.run_soak(args)
    gates = {k: v for k, v in r.items() if k.startswith("ok_")}
    assert all(gates.values()) and r["ok"], {**gates, "windows": r["windows"]}
    lpf = r["launches_per_frame"]
    assert lpf["flash_attention"] == 12 and lpf["pixelwise_score"] == 1 and lpf["slic_step"] == 11
    assert lpf["fill_hulls"] > 0 and r["train_steps"] > 0


def test_estimator_pickled_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator
    from wild_visual_navigation_tpu_torch.traversability.nodes import MissionNode, SupervisionNode

    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 16, "hidden_sizes": [32, 1], "reconstruction": True}}
    est = TraversabilityEstimator(model_cfg=cfg, min_samples_for_training=2, batch_size=4, buffer_capacity=16,
                                  num_segments=9, feature_dim=16, image_height=48, image_width=64,
                                  reprojection_fanout=8, supervision_distance_thr=0.05, image_distance_thr=0.1)
    seg = np.arange(9, dtype=np.int32).reshape(3, 3).repeat(16, 0).repeat(22, 1)[:48, :64]
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    cam = np.eye(4)
    cam[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    cam[2, 3] = 2.0
    rng = np.random.default_rng(0)
    for i, x in enumerate(np.linspace(0, 0.8, 5)):
        pose = np.eye(4)
        pose[0, 3] = x
        est.add_mission_node(MissionNode(timestamp=float(i), pose_base_in_world=pose, pose_cam_in_base=cam),
                             rng.standard_normal((9, 16)).astype(np.float32), np.ones(9, bool), seg, K)
        est.add_supervision_node(SupervisionNode(
            timestamp=i + 0.5, pose_base_in_world=pose, width=0.4, length=0.4, height=0.3,
            twist_in_base=np.array([1.0, 0, 0]), desired_twist_in_base=np.array([1.0, 0, 0]),
            traversability=0.8, traversability_var=1.0, is_untraversable=False))
    for _ in range(3):
        est.train()
    n = port.launch_counts()["fill_hulls"]
    assert n > 0
    path = est.save_pickle(str(tmp_path / "est.pkl"))
    on_cpu = TraversabilityEstimator.load_pickle(path, device="cpu")
    assert on_cpu.step == est.step == 3 and on_cpu._device.type == "cpu"
    for a, b in zip(on_cpu.buffer, est.buffer):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())
    assert on_cpu.train()["loss_total"] > 0 and on_cpu.step == 4
    on_card = TraversabilityEstimator.load_pickle(path)
    assert on_card._device.type == "cuda" and on_card.buffer.features.is_cuda
    assert on_card.train()["loss_total"] > 0


def test_parallel_tp_vit_on_the_card(cuda, tmp_path):
    """The tp = 2 ViT (ViT-S/8 widths, 2 blocks, fp32, 224 px) on 2 Gloo
    ranks sharing the card: K1 on each rank's 3 heads, (1, 3, 785, 64),
    against the unsharded ViT on the card at K1's fp32 limit, 1e-4."""
    from wild_visual_navigation_tpu_torch.models import vit as tvit
    from wild_visual_navigation_tpu_torch.parallel.launch import run_ranks

    import _torch_parallel_ranks as ranks

    cfg = dict(patch_size=8, embed_dim=384, depth=2, num_heads=6, pos_grid_size=28, layerscale_init=None)
    vit = tvit.VisionTransformer(tvit.ViTConfig(**cfg), dtype=torch.float32, device=cuda,
                                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tvit.dense_features(vit, x.to(cuda)).cpu().numpy()
    torch.save({"cfg": cfg, "state": {k: v.cpu() for k, v in vit.state_dict().items()}, "x": x}, tmp_path / "vit.pt")
    for r in run_ranks(ranks.tp_vit_rank, 2, args=(str(tmp_path / "vit.pt"),), timeout=300):
        assert r["launches"] == 2 and r["shapes"] == [(1, 3, 785, 64)]
        np.testing.assert_allclose(r["out"], want, atol=1e-4)


def test_parallel_nccl_world_of_one_runtime(cuda):
    """WVNRuntime with a (1, 1) mesh over NCCL gives exactly the unmeshed
    runtime's maps and losses on the mesh scenario."""
    from wild_visual_navigation_tpu_torch.parallel.launch import run_ranks

    import _torch_parallel_ranks as ranks

    (r,) = run_ranks(ranks.nccl_runtime_rank, 1, backend="nccl", timeout=300)
    assert r["backend"] == "nccl"
    for a, b in zip(r["meshed"]["trav"] + r["meshed"]["conf"], r["plain"]["trav"] + r["plain"]["conf"]):
        np.testing.assert_array_equal(a, b)
    assert r["meshed"]["losses"] == r["plain"]["losses"]


def test_parallel_two_rank_trainer_on_the_card(cuda, capsys):
    """The dryrun's estimators on 2 Gloo ranks sharing the card: both end
    with the same params checksum, the starved phase included."""
    from wild_visual_navigation_tpu_torch.tools import dryrun_multiprocess

    assert dryrun_multiprocess.main(["--procs", "2", "--device", "cuda"]) == 0
    assert "replicated state consistent" in capsys.readouterr().out
