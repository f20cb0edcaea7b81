"""The torch port's WVNRuntime (runtime/runtime.py) and replay harness
(runtime/replay.py) against the JAX runtime, on the CPU, and the port's
runtime on its own: rate gates, scheduler, services, the params mailbox,
the learning thread, shutdown, the options that are not ported, and the
thread safety of the kernel loader.

Against JAX: DINO ViT-S/8 at 48 px (neither package has a smaller DINO
config), fp32 on both sides, a [64, 32, 1] SimpleMLP, buffer 32 and fan-out
8. The JAX runtime's backbone and head are carried into the port's; both
estimators sample from np.random seeded 42 (the JAX estimator's default
seed, which the port's estimator draws from its own RandomState); the same
synthetic_sequence goes through run_replay on both sides."""

import functools
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import cfg as jcfg
from wild_visual_navigation_tpu.feature_extractor import feature_extractor as jfe_mod
from wild_visual_navigation_tpu.feature_extractor.dino import DinoInterface as JDino
from wild_visual_navigation_tpu.runtime import WVNRuntime as JRuntime
from wild_visual_navigation_tpu.runtime import run_replay as jrun_replay
from wild_visual_navigation_tpu_torch import launch_counts
from wild_visual_navigation_tpu_torch.cfg import experiment as tcfg_exp
from wild_visual_navigation_tpu_torch.cfg import node_params as tcfg_node
from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.ops import _cuda
from wild_visual_navigation_tpu_torch.parallel import DistributedTrainer, create_mesh
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, run_replay, synthetic_sequence
from wild_visual_navigation_tpu_torch.runtime.replay import SimWorld, load_sequence, run_closed_loop, save_sequence
from wild_visual_navigation_tpu_torch.utils import timers
from wild_visual_navigation_tpu_torch.utils.params import train_state_from_jax, vit_state_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 48
MAP_ATOL = 2e-3  # trav and conf, as the frame parity test holds them
LOSS_RTOL = 1e-4  # fp32 training from fp32 features that agree to 1e-4
SLIC_MAP_ATOL = 2e-2  # SLIC labels agree in >= 0.99 of pixels, so pooled features may move a little
SLIC_LOSS_RTOL = 1e-2


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


def _params(mod_node, mod_exp, seg="grid", **fe_kw):
    fe_kw = {**dict(network_input_image_height=SIZE, network_input_image_width=SIZE, segmentation_type=seg,
                    feature_type="dino", dino_patch_size=8, slic_num_components=16, grid_cell_size=16,
                    prediction_per_pixel=True, image_callback_rate=1e9), **fe_kw}
    fe = mod_node.FeatureExtractorNodeParams(**fe_kw)
    ln = mod_node.LearningNodeParams(
        network_input_image_height=SIZE, network_input_image_width=SIZE, image_graph_dist_thr=0.05,
        supervision_graph_dist_thr=0.02, min_samples_for_training=3, supervision_callback_rate=1e9,
        robot_width=0.5, robot_length=0.5)
    exp = mod_exp.ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [64, 32, 1]
    return fe, ln, exp


def _port_params(seg="grid", **fe_kw):
    return _params(tcfg_node, tcfg_exp, seg, **fe_kw)


def _jax_runtime(seg, use_fused, backbone_params=None):
    fe, ln, exp = _params(jcfg, jcfg, seg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe_mod, "DinoInterface", functools.partial(JDino, dtype=jnp.float32, attention_impl="xla"))
        return JRuntime(fe_params=fe, ln_params=ln, exp_params=exp, key=jax.random.PRNGKey(0), buffer_capacity=32,
                        reprojection_fanout=8, use_fused=use_fused, backbone_params=backbone_params)


def _carry(jrt, seg="grid", use_fused=True, **kw):
    """A port runtime holding the JAX runtime's backbone, head, Adam
    moments and confidence state."""
    fe, ln, exp = _port_params(seg)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=32, reprojection_fanout=8,
                    use_fused=use_fused, device="cpu", backbone_dtype=torch.float32,
                    backbone_params=vit_state_from_jax(_np(jrt.feature_extractor._extractor.params)), **kw)
    _adopt(rt, jrt)
    return rt


def _adopt(rt, jrt):
    est = jrt.estimator
    rt.adopt_train_state(**train_state_from_jax(*_np((est.params, est._opt_state, est.confidence_state)), est.step))


def _record_losses(rt):
    """Every learning_step's SystemState loss, as a list."""
    out, step = [], rt.learning_step

    def recorded():
        st = step()
        out.append(st.loss_total)
        return st

    rt.learning_step = recorded
    return out


@pytest.fixture(scope="module")
def backbone():
    """JAX-initialised ViT-S/8 params, shared by every JAX runtime here."""
    return _jax_runtime("grid", True).feature_extractor._extractor.params


CASES = {
    "grid-fused": ("grid", True, 3.0),
    "slic-fused": ("slic", True, 2.0),
    "grid-composed": ("grid", False, 2.0),
}


@pytest.fixture(scope="module", params=list(CASES))
def replayed(request, backbone):
    """Both runtimes after the same replay: (case, jrt, rt, jax report,
    port report, jax losses, port losses)."""
    seg, fused, duration = CASES[request.param]
    jrt = _jax_runtime(seg, fused, backbone)
    rt = _carry(jrt, seg, fused)
    assert (rt._fused_frame is not None) == fused == (jrt._fused_frame is not None)
    seq = synthetic_sequence(duration=duration, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=0)
    jl, tl = _record_losses(jrt), _record_losses(rt)
    np.random.seed(42)
    jrep = jrun_replay(jrt, seq)
    trep = run_replay(rt, seq)
    return request.param, jrt, rt, jrep, trep, jl, tl


def test_replay_matches_jax(replayed):
    case, jrt, rt, jrep, trep, jl, tl = replayed
    slic = case.startswith("slic")
    for field in ("frames_processed", "frames_gated", "supervision_updates", "train_steps", "valid_nodes"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.frames_processed >= 10 and trep.train_steps >= 3 and trep.valid_nodes >= 4
    jn, tn = jrt.estimator.get_mission_nodes(), rt.estimator.get_mission_nodes()
    assert [(n.timestamp, n.buffer_slot) for n in tn] == [(n.timestamp, n.buffer_slot) for n in jn]
    assert rt.estimator.step == jrt.estimator.step
    np.testing.assert_allclose(tl, jl, rtol=SLIC_LOSS_RTOL if slic else LOSS_RTOL, atol=1e-7)
    assert trep.final_loss == pytest.approx(jrep.final_loss, rel=SLIC_LOSS_RTOL if slic else LOSS_RTOL)
    trav, conf = trep.last_result.to_numpy()
    atol = SLIC_MAP_ATOL if slic else MAP_ATOL
    np.testing.assert_allclose(trav, np.asarray(jrep.last_result.traversability), atol=atol)
    np.testing.assert_allclose(conf, np.asarray(jrep.last_result.confidence), atol=atol)
    np.testing.assert_array_equal(rt.estimator.buffer.valid.numpy(), np.asarray(jrt.estimator.buffer.valid))
    np.testing.assert_array_equal(rt.estimator.buffer.signal_valid.numpy(), np.asarray(jrt.estimator.buffer.signal_valid))
    if not slic:
        np.testing.assert_array_equal(rt.estimator.buffer.seg.numpy(), np.asarray(jrt.estimator.buffer.seg))
        np.testing.assert_allclose(rt.estimator.buffer.features.numpy(), np.asarray(jrt.estimator.buffer.features),
                                   atol=1e-4)


@pytest.mark.parametrize("replayed", ["grid-fused"], indirect=True)
def test_carried_mid_mission_state_scores_as_jax(replayed):
    """After the replay, the JAX runtime's whole training state moves into
    the port's runtime (adopt_train_state hot-swaps it); both then score
    the same new frame with it."""
    case, jrt, rt, *_ = replayed
    _adopt(rt, jrt)
    jrt.hot_swap()
    f = synthetic_sequence(duration=0.2, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=5).frames[0]
    args = (f.image, 100.0, f.camera, f.K, SIZE, SIZE, f.pose_base_in_world, f.pose_cam_in_base)
    want, got = jrt.image_callback(*args), rt.image_callback(*args)
    trav, conf = got.to_numpy()
    np.testing.assert_allclose(trav, np.asarray(want.traversability), atol=MAP_ATOL)
    np.testing.assert_allclose(conf, np.asarray(want.confidence), atol=MAP_ATOL)


def test_batch_callback_matches_single_callbacks(backbone):
    """image_batch_callback at B=2 against two image_callbacks on a twin
    runtime: the same maps, mission nodes and buffer rows."""
    fe, ln, exp = _port_params("grid")
    kw = dict(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=32, reprojection_fanout=8, device="cpu",
              backbone_dtype=torch.float32, backbone_params=vit_state_from_jax(_np(backbone)))
    rt_b, rt_s = WVNRuntime(**kw), WVNRuntime(**kw)
    rt_s.adopt_train_state(rt_b.estimator.params, None, rt_b.estimator.confidence_state, 0)
    frames = synthetic_sequence(duration=0.8, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=6).frames[:2]
    imgs = np.stack([f.image for f in frames])
    Ks = np.stack([f.K for f in frames])
    pb = np.stack([f.pose_base_in_world for f in frames])
    pc = np.stack([f.pose_cam_in_base for f in frames])
    stamps = [f.stamp for f in frames]
    batch = rt_b.image_batch_callback(imgs, stamps, ["front", "front"], Ks, SIZE, SIZE, pb, pc)
    singles = [rt_s.image_callback(f.image, f.stamp, f.camera, f.K, SIZE, SIZE, f.pose_base_in_world,
                                   f.pose_cam_in_base) for f in frames]
    assert [r.camera for r in batch] == ["front", "front"] and [r.stamp for r in batch] == stamps
    for b, s in zip(batch, singles):
        for x, y in zip(b.to_numpy(), s.to_numpy()):
            np.testing.assert_allclose(x, y, atol=1e-4)  # the batched matmuls block differently
    nb, ns = rt_b.estimator.get_mission_nodes(), rt_s.estimator.get_mission_nodes()
    assert [(n.timestamp, n.buffer_slot) for n in nb] == [(n.timestamp, n.buffer_slot) for n in ns] and len(nb) == 2
    for name in ("features", "feat_valid", "seg", "K", "pose_cam_in_world", "valid"):
        a, b = getattr(rt_b.estimator.buffer, name), getattr(rt_s.estimator.buffer, name)
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="fused path"):
        WVNRuntime(**{**kw, "use_fused": False}).image_batch_callback(imgs, stamps, ["front"] * 2, Ks, SIZE, SIZE,
                                                                      pb, pc)


# ------------------------------------------------------------ the port alone


@pytest.fixture(scope="module")
def port_backbone():
    """A seeded ViT-S/8 state dict shared by the port-only runtimes."""
    from wild_visual_navigation_tpu_torch.models.vit import make_vit

    return make_vit("dino", "vit_small", 8, dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(0)).state_dict()


def _tiny(port_backbone, seg="grid", fe_kw=None, **kw):
    fe, ln, exp = _port_params(seg, **(fe_kw or {}))
    for k in [k for k in kw if hasattr(ln, k)]:
        setattr(ln, k, kw.pop(k))
    return WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=32, reprojection_fanout=8,
                      device="cpu", backbone_dtype=torch.float32, backbone_params=port_backbone, **kw)


def test_rate_gate(port_backbone):
    rt = _tiny(port_backbone)
    rt.fe_params.image_callback_rate = 1.0  # gate to 1 Hz
    seq = synthetic_sequence(duration=3.0, frame_rate=10.0, state_rate=0.0, image_size=SIZE, seed=2)
    report = run_replay(rt, seq)
    assert report.frames_processed == 3 and report.frames_gated == 27
    assert rt.events.snapshot()["events"]["image_callback_canceled"]["value"] == "canceled due to rate"


def test_counters_show_gated_frames_and_the_learner(port_backbone):
    """counters(): the journal's gates, the mission graph's inserts, the
    estimator lock, the flushes and the blocking reads, beside the runtime's
    own hot swaps, step, buffer fill and launches."""
    rt = _tiny(port_backbone)
    rt.fe_params.image_callback_rate = 1.0  # gate to 1 Hz
    timers.reset()
    report = run_replay(rt, synthetic_sequence(duration=3.0, frame_rate=10.0, state_rate=5.0, image_size=SIZE,
                                               seed=2))
    c = rt.counters()
    assert report.frames_gated == 27 and c["events.image_callback_canceled.rate"] == 27
    assert c["events.image_callback_received"] == 30 and "events.image_callback_canceled.scheduler" not in c
    assert c["frames.inserted"] + c.get("frames.gated.graph", 0) == 3 == report.frames_processed
    assert c["buffer_fill"] == c["frames.inserted"] == len(rt.estimator._slot_to_node)
    assert c["hot_swaps"] == rt.hot_swaps and c["estimator.step"] == rt.estimator.step
    assert c["lock.acquired"] > 0 and c.get("lock.contended", 0) == 0  # one thread: nothing waits
    assert c["supervision.flushes"] > 0 and c["sync.supervision_counts"] > 0
    assert set(c["launches"]) == {"flash_attention", "pixelwise_score", "slic_step", "fill_hulls"}


def test_spans_of_a_camera_call_share_its_request(port_backbone):
    """With tracing on, each image_callback is one request rooted at
    `frame`; the frame's stages are its descendants, the learner's spans
    belong to other requests."""
    rt = _tiny(port_backbone, learning_thread_rate=10.0, load_save_checkpoint_rate=2.0, logging_thread_rate=5.0)
    timers.reset()
    timers.set_tracing(True)
    try:
        run_replay(rt, synthetic_sequence(duration=3.0, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=4))
    finally:
        timers.set_tracing(False)
    recs = timers.snapshot()["spans"]
    by_id = {r.span_id: r for r in recs}
    frames = [r for r in recs if r.name == "frame"]
    assert len(frames) == 15 and all(f.parent == 0 for f in frames)
    for f in frames:
        mine = {r.name: r for r in recs if r.request == f.request and r is not f}
        assert {n for n in mine if not n.startswith("sync.")} == {
            "frame.upload", "frame.dispatch", "frame.backbone", "frame.segment", "frame.head", "frame.insert"}
        # the blocking host-to-device copies left in the dispatch: the grid's graph and the tail's; the ImageNet
        # constants stay on the device, so normalising drains nothing
        assert {n for n in mine if n.startswith("sync.")} == {"sync.grid_graph", "sync.pool_matrices",
                                                               "sync.pixelwise_operands"}
        assert "sync.normalize" not in mine
        for r in mine.values():
            parent = by_id[r.parent]
            assert parent.request == f.request and f.start_ns <= r.start_ns <= r.end_ns <= f.end_ns
        assert {mine[k].parent for k in ("frame.backbone", "frame.segment", "frame.head")} == {
            mine["frame.dispatch"].span_id}
    learner = {r.name for r in recs if r.request not in {f.request for f in frames}}
    assert {"supervision", "estimator.reproject", "estimator.train_step", "sync.supervision_counts", "sync.loss",
            "hot_swap"} <= learner
    assert not any(n.startswith("frame") for n in learner)


def test_weighted_scheduler_with_two_cameras(port_backbone):
    """Two cameras share the scheduler 2:1; the use_for_training=False
    camera never enters the mission graph; an unknown camera warns once."""
    topics = {"front": {"use_for_training": True, "scheduler_weight": 2},
              "rear": {"use_for_training": False, "scheduler_weight": 1}}
    rt = _tiny(port_backbone, fe_kw={"camera_topics": topics}, image_graph_dist_thr=0.01)
    K = np.array([[30.0, 0, 24], [0, 30.0, 24], [0, 0, 1]])
    cam_in_base = np.eye(4)
    cam_in_base[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
    cam_in_base[:3, 3] = [0, 0, 2.0]
    rng = np.random.RandomState(0)
    processed = {"front": 0, "rear": 0}
    for i in range(18):
        pose = np.eye(4)
        pose[0, 3] = i * 0.05
        for cam in ("front", "rear"):
            img = rng.rand(3, SIZE, SIZE).astype(np.float32)
            if rt.image_callback(img, i * 0.1, cam, K, SIZE, SIZE, pose, cam_in_base) is not None:
                processed[cam] += 1
    assert processed["front"] > processed["rear"] >= 5
    assert {n.camera_name for n in rt.estimator.get_mission_nodes()} == {"front"}
    with pytest.warns(UserWarning, match="not in camera_topics"):
        rt.image_callback(img, 99.0, "side", K, SIZE, SIZE, np.eye(4), cam_in_base)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rt.image_callback(img, 99.5, "side", K, SIZE, SIZE, np.eye(4), cam_in_base)  # warned once only


def test_checkpoint_services_round_trip(port_backbone, tmp_path):
    rt = _tiny(port_backbone)
    run_replay(rt, synthetic_sequence(duration=3.0, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=3))
    assert rt.estimator.step > 0
    path = rt.save_checkpoint(str(tmp_path))
    rt2 = _tiny(port_backbone)
    swaps = rt2.hot_swaps
    rt2.load_checkpoint(path)
    assert rt2.estimator.step == rt.estimator.step and rt2.hot_swaps == swaps + 1
    for k, v in rt.estimator.params.items():
        torch.testing.assert_close(rt2.inference_head[0].state_dict()[k], v, atol=0, rtol=0)
    rt2.pause_learning(True)
    st = rt2.learning_step()
    assert st.pause_learning and rt2.estimator.step == rt.estimator.step
    rt2.pause_learning(False)
    rt2.reset()
    assert rt2.estimator.step == 0 and rt2.estimator.get_mission_nodes() == []


def test_uint8_frames(port_backbone):
    """A uint8 frame uploads as uint8 and is converted on the device: the
    same maps as the float frame it quantizes to; to_numpy strides and
    quantizes."""
    rt = _tiny(port_backbone)
    f = synthetic_sequence(duration=0.4, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=7).frames[0]
    u8 = (f.image * 255).astype(np.uint8)
    a = rt.image_callback(u8, 0.0, f.camera, f.K, SIZE, SIZE, f.pose_base_in_world, f.pose_cam_in_base)
    b = rt.image_callback(u8.astype(np.float32) / 255.0, 1.0, f.camera, f.K, SIZE, SIZE, f.pose_base_in_world,
                          f.pose_cam_in_base)
    ta, ca = a.to_numpy()
    tb, cb = b.to_numpy()
    assert ta.shape == (SIZE, SIZE) and np.isfinite(ta).all()
    np.testing.assert_allclose(ta, tb, atol=1e-6)
    np.testing.assert_allclose(ca, cb, atol=1e-6)
    qt, qc = a.to_numpy(quantize_uint8=True, stride=2)
    assert qt.dtype == np.uint8 and qt.shape == (SIZE // 2, SIZE // 2)
    np.testing.assert_array_equal(qt, (np.clip(ta[::2, ::2], 0, 1) * 255).astype(np.uint8))


def test_mailbox_is_a_snapshot(port_backbone):
    """Train steps without hot_swap leave the next frame's maps bitwise
    unchanged (inference scores with its own head, not the estimator's
    live one); after hot_swap they change."""
    rt = _tiny(port_backbone)
    seq = synthetic_sequence(duration=3.0, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=1)
    run_replay(rt, seq)
    head, cg = rt.inference_head
    assert not any(p.requires_grad for p in head.parameters())
    assert head is not rt.estimator.model
    f = seq.frames[-1]

    def maps(stamp):
        res = rt.image_callback(f.image, stamp, f.camera, f.K, SIZE, SIZE, f.pose_base_in_world, f.pose_cam_in_base)
        return [torch.stack([res.traversability, res.confidence]).clone()]

    before = maps(100.0)
    step = rt.estimator.step
    for _ in range(5):
        rt.estimator.train()
    assert rt.estimator.step == step + 5
    after_training = maps(101.0)
    assert torch.equal(before[0], after_training[0])
    assert rt.inference_head[0] is head
    rt.hot_swap()
    assert rt.inference_head[0] is not head
    after_swap = maps(102.0)
    assert not torch.equal(before[0], after_swap[0])
    for k, v in rt.estimator.params.items():
        torch.testing.assert_close(rt.inference_head[0].state_dict()[k], v, atol=0, rtol=0)


def test_learning_step_swaps_at_the_checkpoint_rate(port_backbone):
    rt = _tiny(port_backbone, learning_thread_rate=10.0, load_save_checkpoint_rate=2.0)  # a swap every 5 steps
    seq = synthetic_sequence(duration=4.0, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=4)
    steps = []
    orig = rt.hot_swap

    def recorded():
        steps.append(rt.estimator.step)
        orig()

    rt.hot_swap = recorded
    run_replay(rt, seq)
    assert rt.estimator.step >= 10
    assert steps == [s for s in range(0, rt.estimator.step + 1, 5)]


def test_learning_thread_while_frames_arrive(port_backbone):
    """The learning thread at 50 Hz while frames arrive for about a second:
    no error in the journal, the step advances, swaps happen, the maps stay
    finite."""
    rt = _tiny(port_backbone, learning_thread_rate=50.0, load_save_checkpoint_rate=10.0)
    seq = synthetic_sequence(duration=6.0, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=8)
    events = list(seq.events())
    for _, kind, p in events[:16]:  # warm up the graph so training can start
        if kind == "frame":
            rt.image_callback(p.image, p.stamp, p.camera, p.K, SIZE, SIZE, p.pose_base_in_world, p.pose_cam_in_base)
        else:
            rt.robot_state_callback(p.stamp, p.pose_base_in_world, p.current_twist, p.desired_twist)
    swaps0 = rt.hot_swaps
    rt.start_learning_thread()
    t0 = time.time()
    results = []
    try:
        for _, kind, p in events[16:]:
            if kind == "frame":
                res = rt.image_callback(p.image, p.stamp, p.camera, p.K, SIZE, SIZE, p.pose_base_in_world,
                                        p.pose_cam_in_base)
                results.append(res.to_numpy())
            else:
                rt.robot_state_callback(p.stamp, p.pose_base_in_world, p.current_twist, p.desired_twist)
        while time.time() - t0 < 1.0:
            time.sleep(0.02)
    finally:
        rt.stop_learning_thread()
    assert rt._learning_thread is None
    assert rt.events.snapshot()["errors"] == []
    assert rt.estimator.step > 5 and rt.hot_swaps > swaps0
    assert len(results) >= 10 and all(np.isfinite(t).all() and np.isfinite(c).all() for t, c in results)


def test_shutdown_writes_checkpoint_and_journal(port_backbone, tmp_path):
    rt = _tiny(port_backbone)
    run_replay(rt, synthetic_sequence(duration=2.0, frame_rate=5.0, state_rate=5.0, image_size=SIZE, seed=9))
    rt.start_learning_thread()
    path = rt.shutdown(str(tmp_path))
    assert path == str(tmp_path / "last_checkpoint.ckpt") and os.path.exists(path)
    assert rt._learning_thread is None
    import json

    journal = json.loads((tmp_path / "system_events.json").read_text())
    assert "checkpoint stored at" in journal["events"]["shutdown"]["value"]
    assert "image_callback_received" in journal["events"] and journal["errors"] == []
    assert rt.shutdown() is None


def test_swallowed_errors_are_journaled(port_backbone):
    rt = _tiny(port_backbone, swallow_callback_errors=True)
    bad = np.zeros((3, SIZE), np.float32)  # not an image
    assert rt.image_callback(bad, 0.0, "front", np.eye(3), SIZE, SIZE, np.eye(4), np.eye(4)) is None
    snap = rt.events.snapshot()
    assert len(snap["errors"]) == 1 and snap["errors"][0]["name"] == "image_callback_state"


def test_learning_role_runtime_refuses_frames(port_backbone):
    fe, ln, exp = _port_params("grid")
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, device="cpu",
                    build_feature_extractor=False)
    assert rt.feature_extractor is None and rt._fused_frame is None and rt._S == 9 and rt._D == 384
    with pytest.raises(RuntimeError, match="build_feature_extractor=False"):
        rt.image_callback(np.zeros((3, SIZE, SIZE), np.float32), 0.0, "front", np.eye(3), SIZE, SIZE, np.eye(4),
                          np.eye(4))


def test_replay_sequence_files_and_closed_loop(port_backbone, tmp_path):
    seq = synthetic_sequence(duration=1.0, frame_rate=3.0, state_rate=3.0, image_size=32, seed=4)
    path = save_sequence(seq, str(tmp_path / "seq.npz"))
    seq2 = load_sequence(path)
    assert len(seq2.frames) == len(seq.frames) and len(seq2.states) == len(seq.states)
    np.testing.assert_allclose(seq2.frames[0].image, seq.frames[0].image)
    rt = _tiny(port_backbone)
    world = SimWorld(image_size=SIZE, seed=0)
    path_xy, goals = run_closed_loop(rt, world, duration=2.0, rate=5.0)
    # drove straight ahead at 1 m/s without carrots for 2 s (the world's clock sums 0.2 s steps)
    assert path_xy.shape[1] == 4 and len(path_xy) in (10, 11) and goals == []
    assert path_xy[-1, 1] >= 1.8 and np.allclose(path_xy[:, 2:], 0.0)


def _runtime_kw(build_fe, **fe_kw):
    fe, ln, exp = _port_params(**fe_kw)
    return dict(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=8, device="cpu",
                build_feature_extractor=build_fe)


def _anomaly_runtime():
    kw = _runtime_kw(False)
    kw["exp_params"].model.name = "LinearRnvp"
    return WVNRuntime(**kw, anomaly_detection=True)


def _calibrated(rt):
    """rt after calibrate_backbone on two seeded frames, which must say True."""
    rng = np.random.default_rng(0)
    assert rt.calibrate_backbone([rng.random((1, 3, SIZE, SIZE), dtype=np.float32) for _ in range(2)]) is True
    return rt


def _world_of_one(build):
    """build() inside a Gloo process group of one rank (the mesh and the
    distributed trainer need a group), left before returning."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/pg", world_size=1, rank=0)
        try:
            return build()
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("build,item", [
    (lambda: _world_of_one(lambda: WVNRuntime(**_runtime_kw(False), mesh=create_mesh(device="cpu"))), None),
    (lambda: WVNRuntime(**_runtime_kw(False), gridmap_size=64), None),
    (lambda: _anomaly_runtime(), None),
    (lambda: WVNRuntime(**_runtime_kw(True, feature_type="torchvision")), None),
    (lambda: WVNRuntime(**_runtime_kw(True, dino_quant="int8")), None),
    (lambda: _world_of_one(lambda: WVNRuntime(**_runtime_kw(False)).attach_distributed_trainer()), None),
    (lambda: WVNRuntime(**_runtime_kw(False)).get_carrot(), None),
    (lambda: _calibrated(WVNRuntime(**_runtime_kw(True, dino_quant="int8_static"))), None),
    (lambda: WVNRuntime(**_runtime_kw(False)).export_supervision_markers(), None),
    (lambda: _world_of_one(lambda: WVNRuntime(**_runtime_kw(True, dino_quant="int8"), mesh=create_mesh(device="cpu"))),
     None),
], ids=["mesh", "gridmap", "anomaly", "torchvision", "int8", "distributed", "carrot", "calibrate", "markers",
        "mesh-int8"])
def test_unported_options_raise_naming_their_item(build, item):
    """What is not ported would raise naming its ROADMAP.md item; nothing is
    left. Anomaly mode (item 22), the supervision markers (item 23), the
    torchvision branch (item 21), the grid map with its carrot (item 24),
    the mesh and the distributed trainer (item 27, here in a process group
    of one rank), the int8 backbones with calibrate_backbone (item 28) and
    a quantised backbone under a mesh (item 28b) are ported and run."""
    if item is None:
        out = build()
        if isinstance(out, DistributedTrainer):  # a ("dp",) mesh over the one rank, no step yet
            assert out.mesh.mesh_dim_names == ("dp",) and out.step_count == 0
        elif isinstance(out, WVNRuntime) and out.mesh is not None:  # a (1, 1) mesh: nothing to split
            assert tuple(out.mesh.mesh.shape) == (1, 1) and out.estimator._dp == 1
            if out.fe_params.dino_quant is not None:  # the int8 ViT-S/8, no scale to reduce over one rank
                layers = [m for m in out.feature_extractor._extractor.vit.modules() if isinstance(m, tvit.QuantLinear)]
                assert len(layers) == 48 and all(m.scale_group is None and m.tp_group is None for m in layers)
        elif isinstance(out, WVNRuntime) and out.anomaly_detection:
            assert type(out.estimator.model).__name__ == "LinearRnvp"
        elif isinstance(out, WVNRuntime) and out.gridmap is not None:  # a 64 x 64 grid of 0.1 m around the origin
            assert tuple(out.gridmap.weight.shape) == (64, 64) and not bool(out.gridmap.valid.any())
            np.testing.assert_array_equal(out.gridmap.origin_xy, np.float32([-3.2, -3.2]))
        elif isinstance(out, WVNRuntime) and out.fe_params.dino_quant is not None:  # the int8 ViT-S/8 in the frame
            vit = out.feature_extractor._extractor.vit
            kind = tvit.StaticQuantLinear if out.fe_params.dino_quant == "int8_static" else tvit.QuantLinear
            layers = [m for m in vit.modules() if isinstance(m, tvit.QuantLinear)]
            assert len(layers) == 48 and all(type(m) is kind for m in layers) and out._fused_frame is not None
            assert kind is tvit.QuantLinear or all(float(m.amax) > 0 for m in layers)  # calibrated
        elif isinstance(out, WVNRuntime):  # torchvision x grid: the fused CNN-pyramid frame
            assert out._fused_frame is not None and out._D == 960
        elif isinstance(out, tuple):  # no grid map: no carrot
            assert out == (None, None)
        else:  # no robot state yet: an empty ribbon
            assert out.num_triangles == 0 and out.points.shape == (0, 3)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        build()


def test_cuda_runtime_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WVNRuntime(device="cuda", build_feature_extractor=False)


def test_signal_mid_critical_section_defers_shutdown(tmp_path):
    """A SIGTERM landing while the main thread holds the estimator lock
    defers; the next callback's epilogue writes the checkpoint and
    re-raises the signal."""
    script = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams
        from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
        fe = FeatureExtractorNodeParams(network_input_image_height=32, network_input_image_width=32,
                                        segmentation_type="grid")
        rt = WVNRuntime(fe_params=fe, device="cpu", buffer_capacity=4, build_feature_extractor=False)
        rt.install_signal_handlers({str(tmp_path)!r})
        with rt.estimator.lock:
            os.kill(os.getpid(), signal.SIGTERM)
            assert rt._deferred_shutdown is not None, "handler did not defer"
            assert not os.path.exists(os.path.join({str(tmp_path)!r}, "last_checkpoint.ckpt"))
        rt.robot_state_callback(0.0, np.eye(4), np.zeros(6), np.zeros(6))
        print("UNREACHABLE")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == -signal.SIGTERM, (res.returncode, res.stderr[-2000:])
    assert "UNREACHABLE" not in res.stdout
    assert (tmp_path / "last_checkpoint.ckpt").exists() and (tmp_path / "system_events.json").exists()


# ----------------------------------------------- the kernel loader's threads


def test_library_binds_once_across_threads(monkeypatch):
    """Eight threads asking for the kernel library at once get one build
    and one binding (the build and the loader stubbed)."""
    calls = {"build": 0, "load": 0}

    def slow_build():
        calls["build"] += 1
        time.sleep(0.05)
        return "libstub.so"

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self, path):
            calls["load"] += 1
            time.sleep(0.02)
            self._fns = {}

        def __getattr__(self, name):
            return self._fns.setdefault(name, Fn())

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "build", slow_build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", Lib)
    start = threading.Barrier(8)
    got = []

    def worker():
        start.wait()
        got.append(_cuda.library())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert got[0].wvn_slic_step.restype is _cuda.ctypes.c_int


def test_launch_counters_count_every_launch_across_threads(monkeypatch):
    from wild_visual_navigation_tpu_torch.ops.slic_fused import slic_step

    monkeypatch.setattr(slic_step, "launches", 0)
    n_threads, per_thread = max(8, 2 * (os.cpu_count() or 1)), 2000
    start = threading.Barrier(n_threads)

    def worker():
        start.wait()
        for _ in range(per_thread):
            _cuda.count_launch(slic_step)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: an unlocked += would lose updates
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert slic_step.launches == n_threads * per_thread == launch_counts()["slic_step"]


def test_demo_online_and_minimal_example_run_on_the_cpu(tmp_path):
    """The port's demo_online (its flags plus --device) and the minimal
    online loop, at 48 px on the CPU."""
    from wild_visual_navigation_tpu_torch import demo_online
    from wild_visual_navigation_tpu_torch.examples import minimal_online_loop

    st = demo_online.main(["--device", "cpu", "--size", "48", "--duration", "3", "--seg", "grid",
                           "--out", str(tmp_path / "demo")])
    assert st.step > 0 and st.mission_graph_num_valid_node > 0
    assert (tmp_path / "demo" / "learning_curves.csv").exists() and (tmp_path / "demo" / "learning_curves.png").exists()
    assert len(list((tmp_path / "demo" / "images").glob("*.png"))) >= 1
    assert (tmp_path / "demo" / "footprints.ply").read_text().startswith("ply\n")  # the markers, as JAX's demo writes
    report = minimal_online_loop.main(["--device", "cpu", "--size", "48"])
    assert report.frames_processed == 30 and report.train_steps > 0 and np.isfinite(report.final_loss)
