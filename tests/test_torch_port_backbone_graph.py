"""The DINO frame's backbone stage as a CUDA graph (runtime/fused.py::
BackboneGraphs) and the resident constants it needs.

On the CPU: CPU input runs the eager stage and counts it, the resident
ImageNet constants and bicubic matrices equal the per-call ones bit for bit
and are built once per key, the ViT's generation moves with what gives its
layers new tensors, a capture's launches are recorded in place of counted.
On the card (marked `gpu`, skipped elsewhere; this file imports no JAX):
graphed and eager `frames_batch` give bit-identical results, one graph per
input key, K1's counter advancing per replay, a capture beside a learner
thread, concurrent camera threads, and a recapture after calibration.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_backbone_graph.py -q
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import wild_visual_navigation_tpu_torch as port
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.models.registry import get_model
from wild_visual_navigation_tpu_torch.ops import _cuda
from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention
from wild_visual_navigation_tpu_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD, imagenet_constants
from wild_visual_navigation_tpu_torch.runtime.fused import _split_reason, build_fused_frame_fn
from wild_visual_navigation_tpu_torch.utils import timers
from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

GRAPH = "frame.backbone.graph."


@pytest.fixture(autouse=True)
def clean_counters():
    timers.reset()
    yield
    timers.reset()


def _graph_counts() -> dict:
    return {k[len(GRAPH):]: v for k, v in timers.snapshot()["counters"].items() if k.startswith(GRAPH)}


def _mlp(D, device):
    return get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1],
                                                               "reconstruction": True}},
                     device=device, generator=torch.Generator().manual_seed(1))


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------------ CPU


def _tiny_vit(**kw):
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=64, depth=1, num_heads=2, layerscale_init=None, pos_grid_size=4)
    return tvit.VisionTransformer(cfg, dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(0),
                                  **kw)


def test_cpu_input_runs_the_eager_backbone_and_counts_it():
    vit = _tiny_vit()
    frame = build_fused_frame_fn(vit, _mlp(64, "cpu"), ConfidenceConfig(), 48, segmentation_type="grid",
                                 num_segments=9, cell_size=16)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 50, 60), dtype=np.uint8))
    cg = confidence_init("cpu")
    got = [frame.frames_batch(cg, img) for _ in range(2)]
    assert _graph_counts() == {"eager.cpu": 2}
    assert frame.frames_batch.backbone.graphs == {}
    assert _same(got[0], got[1]) and _same(got[0], frame.frames_batch.eager(cg, img))
    assert _graph_counts() == {"eager.cpu": 2}  # the explicit eager stage counts no fallback


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_resident_imagenet_constants_equal_the_per_call_ones(dtype):
    mean, std = imagenet_constants(torch.device("cpu"), dtype)
    assert torch.equal(mean, torch.tensor(IMAGENET_MEAN, dtype=dtype).reshape(3, 1, 1)) and mean.dtype == dtype
    assert torch.equal(std, torch.tensor(IMAGENET_STD, dtype=dtype).reshape(3, 1, 1)) and std.dtype == dtype
    again = imagenet_constants("cpu", dtype)
    assert again[0] is mean and again[1] is std  # built once per (device, dtype)


@pytest.mark.parametrize("grid,out", [(37, 46), (28, 20), (14, 14)])
def test_resident_bicubic_matrices_equal_the_per_call_ones(grid, out):
    M = tvit.bicubic_matrix(grid, out, "cpu")
    assert torch.equal(M, torch.as_tensor(tvit._torch_bicubic_matrix(grid, out))) and M.dtype == torch.float32
    assert tvit.bicubic_matrix(grid, out, torch.device("cpu")) is M  # built once per (device, grid, size)
    pos = torch.randn(grid * grid, 8, generator=torch.Generator().manual_seed(grid))
    want = torch.einsum("pj,ojd->opd", torch.as_tensor(tvit._torch_bicubic_matrix(grid, out)),
                        torch.einsum("oi,ijd->ojd", torch.as_tensor(tvit._torch_bicubic_matrix(grid, out)),
                                     pos.reshape(grid, grid, 8))).reshape(out * out, 8)
    got = tvit._interpolate_pos_embed(pos, grid, out, out)
    assert torch.equal(got, pos if out == grid else want)


def test_vit_generation_moves_with_new_layer_tensors():
    """A load, a calibration and a tensor-parallel cut each move the
    generation, so the frame's key for the same input changes."""
    vit = _tiny_vit(quant="int8_static")
    frame = build_fused_frame_fn(vit, _mlp(64, "cpu"), ConfidenceConfig(), 32, segmentation_type="grid",
                                 num_segments=4, cell_size=16)
    img = torch.zeros(1, 3, 32, 32)
    keys = [frame.frames_batch.backbone.key(img)]
    vit.load_state_dict(vit.state_dict())
    keys.append(frame.frames_batch.backbone.key(img))
    tvit.calibrate_int8_static(vit, [torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(2))])
    keys.append(frame.frames_batch.backbone.key(img))
    assert len(set(keys)) == 3 and keys[0][:-1] == keys[2][:-1] and keys[0][-2] == "int8_static"
    assert [k[-1] for k in keys] == sorted(k[-1] for k in keys)


def test_split_vit_is_told_apart():
    vit = _tiny_vit(quant="int8")
    assert _split_reason(vit) is None
    vit.blocks[0].mlp.fc2.scale_group = object()
    assert _split_reason(vit) == "mesh"
    vit.blocks[0].attn.tp_group = object()
    assert _split_reason(vit) == "tp"


def test_a_capture_records_its_launches_and_a_replay_counts_them():
    """Inside `recording_launches` this thread's launches are recorded, not
    counted, while another thread's count; `count_recorded` adds a record."""

    def wrapper():
        pass

    wrapper.launches, wrapper.variant_launches = 0, {}
    with _cuda.recording_launches() as rec:
        for _ in range(3):
            _cuda.count_launch(wrapper, "bf16 d64 64x64")
        other = threading.Thread(target=_cuda.count_launch, args=(wrapper,))
        other.start()
        other.join()
    assert wrapper.launches == 1 and wrapper.variant_launches == {}
    assert rec == {(wrapper, "bf16 d64 64x64"): 3}
    _cuda.count_launch(wrapper)  # counted again once the block ends
    for _ in range(2):
        _cuda.count_recorded(rec)
    assert wrapper.launches == 8 and wrapper.variant_launches == {"bf16 d64 64x64": 6}


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def vits8():
    """DINO ViT-S/8 in bf16 on the card (built once for the module) and its head."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    vit = tvit.make_vit("dino", "vit_small", 8, device=cuda, generator=torch.Generator().manual_seed(0))
    return vit, _mlp(384, cuda)


def _frames(cuda, n, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda) for _ in range(n)]


def _storage(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


def _aliases(result, g) -> bool:
    """Whether a field of `result` shares memory with a static buffer of `g`."""
    static = [_storage(t) for t in (g.static_in, *g.out)]
    return any(a0 < b1 and b0 < a1 for f in result for a0, a1 in [_storage(f)] for b0, b1 in static)


@pytest.mark.gpu
def test_graphed_frame_equals_eager_at_vits8_224(cuda, vits8):
    """ViT-S/8 at 224, B = 1, SLIC, scored per pixel: the key's first call
    runs eagerly and captures (K1 counted 12 times, not 24), then three
    distinct frames replay, each bit-identical to the eager stage, K1's
    counter advancing by 12 a replay, no field aliasing the graph."""
    vit, mlp = vits8
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    imgs = _frames(cuda, 4, (1, 3, 480, 640), seed=0)
    cg = confidence_init(cuda)
    port.reset_launch_counts()
    first = fb(cg, imgs[0])
    torch.cuda.synchronize()
    assert port.launch_counts()["flash_attention"] == 12 and _graph_counts() == {"captures": 1}
    assert _same(first, fb.eager(cg, imgs[0]))
    (g,) = fb.backbone.graphs.values()
    assert g.reason is None and g.launches == {(flash_attention, "bf16 d64 64x64"): 12}
    for i, img in enumerate(imgs[1:], 1):
        n = port.launch_counts()
        got = fb(cg, img)
        torch.cuda.synchronize()
        assert port.launch_counts() == {**n, "flash_attention": n["flash_attention"] + 12,
                                        "slic_step": n["slic_step"] + 11, "pixelwise_score": n["pixelwise_score"] + 1}
        assert not _aliases(got, g)
        assert _same(got, fb.eager(cg, img))
        assert not _same(got, first)  # a distinct frame: the static input was refreshed
    assert _graph_counts() == {"captures": 1, "replays": 3}


@pytest.mark.gpu
def test_graphed_frame_equals_eager_at_vitb14_644_batch(cuda):
    """ViT-B/14 at 644 (two blocks), B = 4, a 64-px grid, scored at patch
    resolution (the positional table resized from 37 to 46): bit-identical
    over three distinct batches."""
    cfg = tvit.ViTConfig(patch_size=14, embed_dim=768, depth=2, num_heads=12, layerscale_init=1.0)
    vit = tvit.VisionTransformer(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    fb = build_fused_frame_fn(vit, _mlp(768, cuda), ConfidenceConfig(), 644, segmentation_type="grid",
                              num_segments=121, cell_size=64, score_at_patch_res=True).frames_batch
    cg = confidence_init(cuda)
    imgs = _frames(cuda, 4, (4, 3, 720, 960), seed=1)
    for img in imgs:
        got = fb(cg, img)
        assert _same(got, fb.eager(cg, img))
        assert got.traversability.shape == (4, 644, 644) and bool(torch.isfinite(got.traversability).all())
    assert _graph_counts() == {"captures": 1, "replays": 3}


@pytest.mark.gpu
def test_each_input_key_captures_its_own_graph(cuda, vits8):
    vit, mlp = vits8
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    cg = confidence_init(cuda)
    a, b = _frames(cuda, 2, (1, 3, 480, 640), seed=2), _frames(cuda, 2, (1, 3, 360, 640), seed=3)
    for img in (a[0], b[0], a[1], b[1]):
        assert _same(fb(cg, img), fb.eager(cg, img))
    assert _graph_counts() == {"captures": 2, "replays": 2}
    assert sorted(k[2:5] for k in fb.backbone.graphs) == [(3, 360, 640), (3, 480, 640)]


@pytest.mark.gpu
def test_camera_threads_read_their_own_features(cuda, vits8):
    """More camera threads than cores call one frame function at once, the
    interpreter switching threads every 10 µs, each on its own frames of one
    key: every result equals the eager result for its own frame."""
    vit, mlp = vits8
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    cg = confidence_init(cuda)
    cams = [_frames(cuda, 2, (1, 3, 480, 640), seed=10 + c) for c in range((os.cpu_count() or 1) + 1)]
    want = [[fb.eager(cg, img) for img in frames] for frames in cams]
    fb(cg, cams[0][0])  # the capture
    bad, done = [], []

    def camera(c):
        torch.cuda.set_device(cams[c][0].device)
        for rep in range(4):
            for i, img in enumerate(cams[c]):
                if not _same(fb(cg, img), want[c][i]):
                    bad.append((c, rep, i))
        done.append(c)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=camera, args=(c,)) for c in range(len(cams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(len(cams)))
    assert bad == [] and _graph_counts() == {"captures": 1, "replays": 8 * len(cams)}


def _runtime(cuda, **fe_kw):
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    fe = FeatureExtractorNodeParams(image_callback_rate=1e9, **fe_kw)
    ln = LearningNodeParams(supervision_callback_rate=1e9, min_samples_for_training=0, learning_thread_rate=100.0)
    return WVNRuntime(fe_params=fe, ln_params=ln, seed=0, device=cuda)


def _demo():
    from pathlib import Path

    return np.load(Path(__file__).resolve().parent.parent / "assets/sequences/demo_mission.npz")


def _feed(rt, seq, frames):
    for i in frames:
        rt.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i], 64, 64,
                          seq["frame_pose"][i], seq["frame_cam_in_base"][i])
        rt.robot_state_callback(float(seq["state_stamps"][i]), seq["state_pose"][i], seq["state_twist"][i],
                                seq["state_desired"][i])


@pytest.mark.gpu
def test_capture_beside_a_learning_thread(cuda):
    """The runtime's learning thread ticks (train steps, hot swaps, loss
    reads) and a checker thread reads back device products while the
    camera captures a new key: the frame equals the eager stage, the
    learner raises nothing and trains, the checker's products are exact."""
    rt = _runtime(cuda)
    seq = _demo()
    _feed(rt, seq, range(6))
    step0 = rt.estimator.step
    a = torch.randn(256, 256, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    want = a @ a
    stop, wrong, checked = threading.Event(), [], []

    def checker():
        try:
            torch.cuda.set_device(a.device)
            while not stop.is_set():
                if not torch.equal((a @ a).cpu(), want.cpu()):
                    wrong.append("a product changed")
                checked.append(1)
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            wrong.append(exc)

    side = threading.Thread(target=checker)
    rt.start_learning_thread()
    side.start()
    try:
        fb = rt._fused_frame.frames_batch
        head, cg = rt.inference_head
        imgs = _frames(cuda, 3, (2, 3, 300, 400), seed=4)
        got = [fb(cg, img, head) for img in imgs]  # the first captures while the learner ticks
    finally:
        stop.set()
        side.join(timeout=60)
        rt.stop_learning_thread()
    assert not side.is_alive()
    for img, res in zip(imgs, got):
        assert _same(res, fb.eager(cg, img, head))
    assert rt.events.snapshot()["errors"] == [] and wrong == [] and len(checked) > 0
    assert rt.estimator.step > step0 and np.isfinite(rt.estimator.loss)
    counts = _graph_counts()
    assert counts["replays"] >= 2 and "eager.capture" not in counts


@pytest.mark.gpu
def test_calibration_recaptures_the_graph(cuda):
    """An int8_static backbone: a calibration moves the ViT's generation, so
    the next frame captures anew, with the new scales."""
    rt = _runtime(cuda, dino_quant="int8_static")
    rng = np.random.default_rng(5)
    rt.calibrate_backbone([rng.random((2, 3, 224, 224), dtype=np.float32)])
    fb = rt._fused_frame.frames_batch
    head, cg = rt.inference_head
    img = _frames(cuda, 1, (1, 3, 480, 640), seed=6)[0]
    before = [fb(cg, img, head) for _ in range(2)]
    assert _graph_counts() == {"captures": 1, "replays": 1}
    rt.calibrate_backbone([rng.random((2, 3, 224, 224), dtype=np.float32) * 4.0])
    after = [fb(cg, img, head) for _ in range(2)]
    assert _graph_counts() == {"captures": 2, "replays": 2} and len(fb.backbone.graphs) == 1
    assert _same(before[0], before[1]) and _same(after[0], after[1])
    assert _same(after[1], fb.eager(cg, img, head)) and not _same(after[1], before[1])
