"""The whole DINO frame as a CUDA graph (runtime/fused.py::StageGraphs)
and the resident constants it needs.

On the CPU: CPU input runs the eager frame and counts it, the resident
constants (ImageNet, bicubic, SLIC's initial indices, the pooling and K2
matrices, K2's row operands, the grid's ids and graph, the patch-resolution
interpolation taps) equal the per-call ones bit for bit and are built once
per key, a frame after the first opens no `sync.*` span, the key holds the
head's structure, a graph's head is its own copy and a write in place is
seen, the ViT's generation moves with what gives its layers new tensors, a
capture's launches are recorded in place of counted.
On the card (marked `gpu`, skipped elsewhere; this file imports no JAX):
graphed and eager `frames_batch` give bit-identical results, one graph per
input key, the kernels' counters advancing per replay, a hot swap copied
into the graph, a head whose capture raises run eagerly, a capture beside a
learner thread, concurrent camera threads, and a recapture after
calibration.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_backbone_graph.py -q
"""

import copy
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
from wild_visual_navigation_tpu_torch.ops import pixelwise_fused, resize, segment_ops, slic
from wild_visual_navigation_tpu_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD, imagenet_constants
from wild_visual_navigation_tpu_torch.runtime.fused import (_segmentation, _split_reason, _static_copy,
                                                            build_fused_frame_fn)
from wild_visual_navigation_tpu_torch.utils import timers
from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

GRAPH = "frame.graph."


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
    assert frame.frames_batch.graphs.graphs == {}
    assert _same(got[0], got[1]) and _same(got[0], frame.frames_batch.eager(cg, img))
    assert _graph_counts() == {"eager.cpu": 2}  # the explicit eager frame counts no fallback


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


def _old_interpolate_bilinear(x, new_h, new_w):
    """interpolate_bilinear as it built its taps on every call."""
    h, w = x.shape[-2], x.shape[-1]

    def coords(out, inp):
        if out == 1:
            return torch.zeros(1, dtype=torch.float32)
        return torch.arange(out, dtype=torch.float32) * np.float32((inp - 1) / (out - 1))

    fy, fx = coords(new_h, h), coords(new_w, w)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(fx).to(torch.int64).clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    wy, wx = (fy - y0.float())[:, None], (fx - x0.float())[None, :]
    top = x[..., y0, :][..., x0] * (1 - wx) + x[..., y0, :][..., x1] * wx
    bot = x[..., y1, :][..., x0] * (1 - wx) + x[..., y1, :][..., x1] * wx
    return top * (1 - wy) + bot * wy


@pytest.mark.parametrize("what", ["slic_init", "pool_matrices", "k2_matrices", "k2_rows", "grid", "patch_taps"])
@pytest.mark.parametrize("out,inp", [(224, 28), (644, 46)])
def test_resident_frame_constants_equal_the_per_call_ones(what, out, inp):
    """Each constant the frame's tail reads, as it stays on the device,
    equals what the per-call code built, and a second request returns the
    same tensors."""
    cpu = torch.device("cpu")
    if what == "slic_init":
        for K in (64, 100):
            got = slic.init_index(K, out, out + 8, cpu)
            assert torch.equal(got, slic._init_index(K, out, out + 8)) and got.dtype == torch.int64
            assert slic.init_index(K, out, out + 8, "cpu") is got
    elif what == "pool_matrices":
        for dtype in (torch.float32, torch.bfloat16):
            got = resize.bilinear_matrix(out, inp, cpu, dtype)
            assert torch.equal(got, torch.as_tensor(resize._bilinear_matrix_np(out, inp), dtype=dtype))
            assert got.dtype == dtype and resize.bilinear_matrix(out, inp, "cpu", dtype) is got
    elif what == "k2_matrices":
        Mq, Mx = resize.bilinear_pair_matrices(out, inp, cpu)
        want = resize._bilinear_pair_matrices_np(out, inp)
        assert torch.equal(Mq, torch.as_tensor(want[0])) and torch.equal(Mx, torch.as_tensor(want[1]))
        assert resize.bilinear_pair_matrices(out, inp, "cpu")[1] is Mx
    elif what == "k2_rows":
        starts, coef, runs = pixelwise_fused._row_operands(out, inp, cpu)
        want_s, want_c = pixelwise_fused._row_tables(out, inp)
        assert torch.equal(starts, torch.as_tensor(want_s)) and torch.equal(coef, torch.as_tensor(want_c))
        assert torch.equal(runs, torch.as_tensor(pixelwise_fused._row_runs(want_s))) and runs.dtype == torch.int32
        assert pixelwise_fused._row_operands(out, inp, "cpu")[2] is runs
    elif what == "grid":
        cell = out // 7
        segments, graph = _segmentation("grid", out, out, 64, 10.0, 10, cell, 256)
        seg = segments(torch.zeros(2, 3, out, out))
        assert seg.shape == (2, out, out) and all(torch.equal(s, segment_ops.segment_grid(out, out, cell)) for s in seg)
        got = graph(seg[0])
        want = segment_ops.grid_constants(out, out, cell, 64, max_edges=256)
        assert all(torch.equal(a, b) for a, b in zip(got, want[:3]))
        assert all(a is b for a, b in zip(graph(seg[1]), got))
        assert segments(torch.ones(1, 3, out, out))[0].data_ptr() == seg.data_ptr()
    else:  # the patch-resolution scores' upsample
        x = torch.randn(1, 1, inp, inp + 3, generator=torch.Generator().manual_seed(out))
        assert torch.equal(resize.interpolate_bilinear(x, out, out + 5), _old_interpolate_bilinear(x, out, out + 5))
        assert resize.bilinear_taps(out, inp, "cpu")[2] is resize.bilinear_taps(out, inp, cpu)[2]


@pytest.mark.parametrize("seg_type,patch_res", [("slic", False), ("grid", False), ("grid", True)])
def test_a_frame_after_the_first_opens_no_sync_span(seg_type, patch_res):
    """With tracing on, a frame's dispatch copies nothing from the host: no
    `sync.*` span opens, on the first frame of a shape or the second."""
    vit = _tiny_vit()
    frame = build_fused_frame_fn(vit, _mlp(64, "cpu"), ConfidenceConfig(), 48, segmentation_type=seg_type,
                                 num_segments=9, cell_size=16, score_at_patch_res=patch_res)
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 2, 3, 50, 60), dtype=np.uint8))
    cg = confidence_init("cpu")
    timers.set_tracing(True)
    try:
        names = []
        for img in imgs:
            timers.reset()
            frame.frames_batch(cg, img)
            names.append({r.name for r in timers.snapshot()["spans"]})
    finally:
        timers.set_tracing(False)
    for got in names:
        assert {"frame.backbone", "frame.segment", "frame.head"} <= got
        assert not [n for n in got if n.startswith("sync.")]


def test_the_key_holds_the_head_structure_and_a_graph_owns_its_copies():
    """Heads of one structure share a key and heads of another do not; the
    graph's copy of a head and of a ConfidenceState holds equal values in
    tensors of its own; a write in place moves the versions a replay reads."""
    vit = _tiny_vit()
    graphs = build_fused_frame_fn(vit, _mlp(64, "cpu"), ConfidenceConfig(), 32, segmentation_type="grid",
                                  num_segments=4, cell_size=16).frames_batch.graphs
    img = torch.zeros(1, 3, 32, 32)
    a, cg = _mlp(64, "cpu"), confidence_init("cpu")
    b = copy.deepcopy(a)
    wider = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 64, "hidden_sizes": [128, 32, 1],
                                                                "reconstruction": True}}, device="cpu")
    assert graphs.key(img, a, cg) == graphs.key(img, b, cg) != graphs.key(img, wider, cg)
    assert graphs.key(img, a, cg)[:5] == graphs.key(img)[:5] and graphs.key(img, a, cg)[-2:] == graphs.key(img)[-2:]
    own_head, own_cg = _static_copy(a), _static_copy(cg)
    assert type(own_cg) is type(cg) and not any(p.requires_grad for p in own_head.parameters())
    for mine, theirs in [(list(own_head.parameters()), list(a.parameters())), (list(own_cg), list(cg))]:
        assert all(torch.equal(x, y) and x.data_ptr() != y.data_ptr() for x, y in zip(mine, theirs))
    before = graphs._fed((a, cg))
    assert before[0] == (a, cg) and graphs._fed((a, cg))[1] == before[1]
    with torch.no_grad():
        a.layers[0].bias.add_(1.0)
    assert graphs._fed((a, cg))[1] != before[1]


def test_vit_generation_moves_with_new_layer_tensors():
    """A load, a calibration and a tensor-parallel cut each move the
    generation, so the frame's key for the same input changes."""
    vit = _tiny_vit(quant="int8_static")
    frame = build_fused_frame_fn(vit, _mlp(64, "cpu"), ConfidenceConfig(), 32, segmentation_type="grid",
                                 num_segments=4, cell_size=16)
    img = torch.zeros(1, 3, 32, 32)
    keys = [frame.frames_batch.graphs.key(img)]
    vit.load_state_dict(vit.state_dict())
    keys.append(frame.frames_batch.graphs.key(img))
    tvit.calibrate_int8_static(vit, [torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(2))])
    keys.append(frame.frames_batch.graphs.key(img))
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
    static = [_storage(t) for t in (g.static_in, *g.out, *g.own)]
    return any(a0 < b1 and b0 < a1 for f in result for a0, a1 in [_storage(f)] for b0, b1 in static)


@pytest.mark.gpu
def test_graphed_frame_equals_eager_at_vits8_224(cuda, vits8):
    """ViT-S/8 at 224, B = 1, SLIC (K3), scored per pixel (K2): the key's
    first call runs eagerly and captures (K1 counted 12 times, not 24), then
    three distinct frames replay, each bit-identical to the eager frame,
    K1's counter advancing by 12 a replay, K3's by 11 and K2's by 1, no
    field aliasing the graph, no head copied."""
    vit, mlp = vits8
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    imgs = _frames(cuda, 4, (1, 3, 480, 640), seed=0)
    cg = confidence_init(cuda)
    port.reset_launch_counts()
    first = fb(cg, imgs[0])
    torch.cuda.synchronize()
    assert port.launch_counts()["flash_attention"] == 12 and _graph_counts() == {"captures": 1}
    assert _same(first, fb.eager(cg, imgs[0]))
    (g,) = fb.graphs.graphs.values()
    assert g.reason is None and g.launches[(flash_attention, "bf16 d64 64x64")] == 12
    assert sorted(n for (w, _), n in g.launches.items() if w is not flash_attention) == [1, 11]
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


def _perturbed(mlp, cg, seed):
    """Another head and ConfidenceState of the same structure, as a hot swap
    publishes them: new objects with new values."""
    head = copy.deepcopy(mlp).requires_grad_(False)
    g = torch.Generator(device=mlp.layers[0].weight.device).manual_seed(seed)
    with torch.no_grad():
        for p in head.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=p.device))
    return head, cg._replace(mean=cg.mean + 0.01 * seed, std=cg.std * (1.0 + 0.1 * seed))


@pytest.mark.gpu
def test_a_hot_swap_is_copied_into_the_graph(cuda, vits8):
    """Frames between hot swaps: re-passing the head and the ConfidenceState
    copies nothing; a new pair (a hot swap) is copied in once before the next
    replay, which then scores with it, equal to the eager frame with it and
    not to the one with the old head; a write in place into the head is
    copied in too."""
    vit, mlp = vits8
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    imgs = _frames(cuda, 4, (1, 3, 480, 640), seed=20)
    head0, cg0 = _perturbed(mlp, confidence_init(cuda), 0)
    head1, cg1 = _perturbed(mlp, cg0, 1)
    fb(cg0, imgs[0], head0)  # the capture, from head0
    got = fb(cg0, imgs[1], head0)
    assert _same(got, fb.eager(cg0, imgs[1], head0)) and _graph_counts() == {"captures": 1, "replays": 1}
    got = fb(cg1, imgs[2], head1)
    assert _graph_counts() == {"captures": 1, "replays": 2, "head_copies": 1}
    assert _same(got, fb.eager(cg1, imgs[2], head1)) and not _same(got, fb.eager(cg0, imgs[2], head0))
    got = fb(cg1, imgs[3], head1)
    assert _same(got, fb.eager(cg1, imgs[3], head1)) and _graph_counts()["head_copies"] == 1
    with torch.no_grad():
        head1.layers[-1].bias.add_(0.25)
    got = fb(cg1, imgs[3], head1)
    assert _same(got, fb.eager(cg1, imgs[3], head1)) and _graph_counts()["head_copies"] == 2
    got = fb(cg0, imgs[1], head0)  # back to the first pair
    assert _same(got, fb.eager(cg0, imgs[1], head0)) and _graph_counts() == {"captures": 1, "replays": 5,
                                                                               "head_copies": 3}


class _HostReadingHead(torch.nn.Module):
    """A row head that reads a value back to the host in its forward, which a
    CUDA graph's capture refuses."""

    def __init__(self, mlp):
        super().__init__()
        self.mlp = mlp

    def forward(self, x):
        out = self.mlp(x)
        return out * float(bool(torch.isfinite(out).all()))


@pytest.mark.gpu
def test_a_head_whose_capture_raises_runs_eagerly(cuda, vits8):
    """The capture raises (warned once): the key runs eagerly from then on,
    counted by reason, each frame equal to the eager frame."""
    vit, mlp = vits8
    head = _HostReadingHead(mlp)
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    imgs = _frames(cuda, 3, (1, 3, 480, 640), seed=30)
    cg = confidence_init(cuda)
    with pytest.warns(UserWarning, match="could not be captured"):
        got = [fb(cg, img, head) for img in imgs]
    assert _graph_counts() == {"eager.capture": 2}
    assert [g.reason for g in fb.graphs.graphs.values()] == ["capture"]
    for img, res in zip(imgs, got):
        assert _same(res, fb.eager(cg, img, head))
    assert _same(fb(cg, imgs[0]), fb.eager(cg, imgs[0]))  # another head's key captures
    assert _graph_counts() == {"eager.capture": 2, "captures": 1}


@pytest.mark.gpu
def test_each_input_key_captures_its_own_graph(cuda, vits8):
    vit, mlp = vits8
    fb = build_fused_frame_fn(vit, mlp, ConfidenceConfig(), 224).frames_batch
    cg = confidence_init(cuda)
    a, b = _frames(cuda, 2, (1, 3, 480, 640), seed=2), _frames(cuda, 2, (1, 3, 360, 640), seed=3)
    for img in (a[0], b[0], a[1], b[1]):
        assert _same(fb(cg, img), fb.eager(cg, img))
    assert _graph_counts() == {"captures": 2, "replays": 2}
    assert sorted(k[2:5] for k in fb.graphs.graphs) == [(3, 360, 640), (3, 480, 640)]


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
    assert _graph_counts() == {"captures": 2, "replays": 2} and len(fb.graphs.graphs) == 1
    assert _same(before[0], before[1]) and _same(after[0], after[1])
    assert _same(after[1], fb.eager(cg, img, head)) and not _same(after[1], before[1])
