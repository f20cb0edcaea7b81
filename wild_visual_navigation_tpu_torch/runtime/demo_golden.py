"""The demo golden replay on the port.

`tools/make_demo_assets.py` recorded `assets/goldens/demo_mission_replay.npz`
by replaying the committed demo mission (`assets/sequences/demo_mission.npz`)
through the JAX runtime with dense SIFT features on a 64-px grid of 8-px
cells, a [64, 32, 1] head, lr 3e-3, buffer 64 and fan-out 16, four learning
steps per robot state, then scoring the frame at `probe_stamp` and drawing
`LearningVisualizer`'s overlay of it. The port replays the same sequence
with the same settings, from the same initial head
(`assets/goldens/demo_mission_head_init_torch.npz`, written by
tools/convert_golden_head_to_torch.py) and the same batch draws (the JAX run
seeds the global np.random with 7 after construction; here
`sampling_seed=7`), and is held to the golden's own limits:

    train steps within max(2, golden // 10) of the golden's,
    traversability MAE < 0.05, overlay MAE < 8.0 (uint8).

On a CUDA device every flush launches K4; dense SIFT and the grid are
plain PyTorch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..cfg.experiment import ExperimentParams
from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from ..utils.params import confidence_state_from_jax, load_head_npz, mlp_state_from_jax
from ..visu import LearningVisualizer
from .replay import load_sequence, run_replay
from .runtime import WVNRuntime

ASSETS = Path(__file__).resolve().parents[2] / "assets"
SEQUENCE = ASSETS / "sequences/demo_mission.npz"
GOLDEN = ASSETS / "goldens/demo_mission_replay.npz"
HEAD = ASSETS / "goldens/demo_mission_head_init_torch.npz"
TRAV_MAE_LIMIT = 0.05
OVERLAY_MAE_LIMIT = 8.0


def build_golden_runtime(device="cuda", head_path=HEAD) -> WVNRuntime:
    """The golden's runtime (tools/make_demo_assets.py::build_runtime's
    settings) holding the golden's initial head."""
    size = 64
    fe = FeatureExtractorNodeParams(
        network_input_image_height=size, network_input_image_width=size, segmentation_type="grid",
        feature_type="sift", prediction_per_pixel=False, image_callback_rate=1000.0, grid_cell_size=8)
    ln = LearningNodeParams(
        network_input_image_height=size, network_input_image_width=size, image_graph_dist_thr=0.15,
        supervision_graph_dist_thr=0.05, min_samples_for_training=4, supervision_callback_rate=1000.0,
        robot_width=0.8, robot_length=0.8, traversability_radius=4.0)
    exp = ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [64, 32, 1]
    exp.optimizer.lr = 3e-3
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=64, reprojection_fanout=16,
                    device=device, sampling_seed=7)
    params, cg, step = load_head_npz(head_path)
    rt.adopt_train_state(mlp_state_from_jax(params), None, confidence_state_from_jax(cg), step)
    return rt


def replay_against_golden(device="cuda") -> dict:
    """Replay the demo mission, score the probe frame, draw its overlay,
    and compare with the golden. Returns the numbers and whether each
    meets its limit (`ok` when all do)."""
    seq = load_sequence(str(SEQUENCE))
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    rt = build_golden_runtime(device)
    report = run_replay(rt, seq, train_every_state=4)
    frame = next(f for f in seq.frames if abs(f.stamp - float(golden["probe_stamp"])) < 1e-6)
    res = rt.image_callback(frame.image, 1e6, frame.camera, frame.K, 64, 64, frame.pose_base_in_world,
                            frame.pose_cam_in_base)
    trav = res.traversability.float().cpu().numpy()
    overlay = np.asarray(LearningVisualizer().plot_traversability_overlay(frame.image, trav))
    g_steps = int(golden["train_steps"])
    out = {
        "train_steps": report.train_steps,
        "golden_train_steps": g_steps,
        "steps_limit": max(2, g_steps // 10),
        "valid_nodes": report.valid_nodes,
        "golden_valid_nodes": int(golden["valid_nodes"]),
        "flushes": report.supervision_updates,
        "trav_mae": float(np.abs(trav - golden["traversability"]).mean()),
        "overlay_mae": float(np.abs(overlay.astype(np.float32) - golden["overlay"].astype(np.float32)).mean()),
        "overlay_shape_ok": overlay.shape == golden["overlay"].shape,
    }
    out["ok"] = (abs(out["train_steps"] - g_steps) <= out["steps_limit"] and out["trav_mae"] < TRAV_MAE_LIMIT
                 and out["overlay_shape_ok"] and out["overlay_mae"] < OVERLAY_MAE_LIMIT)
    rt.shutdown()
    return out
