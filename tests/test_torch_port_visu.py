"""The torch port's visu/ (copies of the JAX package's numpy modules),
scripts/overlay_images.py, the postprocess logger's panel,
WVNRuntime.export_supervision_markers, and the demo golden replay
(runtime/demo_golden.py) on the CPU against assets/goldens/demo_mission_replay.npz
at the golden's own limits, with the committed initial head held equal to
what the JAX package builds."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from wild_visual_navigation_tpu import visu as jvisu
from wild_visual_navigation_tpu.scripts import overlay_images as joverlay
from wild_visual_navigation_tpu.traversability import SupervisionNode as JSupervisionNode
from wild_visual_navigation_tpu_torch import visu as tvisu
from wild_visual_navigation_tpu_torch.cfg import experiment as texp
from wild_visual_navigation_tpu_torch.cfg import node_params as tnode
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
from wild_visual_navigation_tpu_torch.runtime import demo_golden
from wild_visual_navigation_tpu_torch.scripts import overlay_images as toverlay
from wild_visual_navigation_tpu_torch.scripts.postprocess_logger import MissionLogger
from wild_visual_navigation_tpu_torch.traversability.nodes import SupervisionNode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine's cores;
    torch's own pool of a thread per core on top of them oversubscribes the
    cores, and small ops then wait tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("squeeze,stretch", [(None, 1.0), (0.3, 1.0), (None, 2.5)], ids=["plain", "squeeze", "stretch"])
def test_colormap_equals_jax_to_the_bit(squeeze, stretch):
    v = np.random.default_rng(0).random((17, 23)).astype(np.float32)
    v[0, :3] = [np.nan, -0.5, 1.5]
    np.testing.assert_array_equal(tvisu.colormap_rdylbu(v, stretch=stretch, squeeze=squeeze),
                                  jvisu.colormap_rdylbu(v, stretch=stretch, squeeze=squeeze))


def test_overlays_equal_jax_to_the_bit():
    rng = np.random.default_rng(1)
    img = rng.random((3, 20, 28)).astype(np.float32)
    trav, conf = rng.random((2, 20, 28)).astype(np.float32)
    tv, jv = tvisu.LearningVisualizer(), jvisu.LearningVisualizer()
    np.testing.assert_array_equal(tv.plot_traversability_overlay(img, trav), jv.plot_traversability_overlay(img, trav))
    np.testing.assert_array_equal(tv.plot_traversability_overlay(img, trav, conf),
                                  jv.plot_traversability_overlay(img, trav, conf))
    np.testing.assert_array_equal(toverlay.overlay(img, trav, alpha=0.3), joverlay.overlay(img, trav, alpha=0.3))
    np.testing.assert_array_equal(tv.plot_mission_node_prediction(img, trav, conf),
                                  jv.plot_mission_node_prediction(img, trav, conf))


def _supervision_nodes(cls, n=6):
    nodes = []
    for i in range(n):
        T = np.eye(4)
        T[:2, 3] = [0.3 * i, 0.05 * i]
        nodes.append(cls(timestamp=float(i), pose_base_in_world=T, width=0.6, length=1.0, height=0.3,
                         twist_in_base=np.array([1.0, 0, 0]), desired_twist_in_base=np.array([1.0, 0, 0]),
                         traversability=0.2 * (i % 5), traversability_var=1.0, is_untraversable=i == 3))
    return nodes


def test_markers_equal_jax(tmp_path):
    got = tvisu.build_footprint_ribbon(_supervision_nodes(SupervisionNode))
    want = jvisu.build_footprint_ribbon(_supervision_nodes(JSupervisionNode))
    assert got.num_triangles == want.num_triangles == 2 * 5 + 2
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.to_json() == want.to_json()
    got.to_ply(str(tmp_path / "t.ply"))
    want.to_ply(str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()
    np.testing.assert_array_equal(tvisu.build_graph_path(_supervision_nodes(SupervisionNode)),
                                  jvisu.build_graph_path(_supervision_nodes(JSupervisionNode)))


def test_runtime_exports_supervision_markers(tmp_path):
    """The robot's driven footprint through the port's runtime, written as
    PLY and JSON: the ribbon the JAX package's visu/ builds from the same
    supervision nodes."""
    fe = tnode.FeatureExtractorNodeParams(network_input_image_height=32, network_input_image_width=32,
                                          segmentation_type="grid", feature_type="sift", grid_cell_size=8)
    ln = tnode.LearningNodeParams(supervision_callback_rate=1e9, supervision_graph_dist_thr=0.05)
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=texp.ExperimentParams(), buffer_capacity=8,
                    device="cpu", build_feature_extractor=False)
    for i in range(6):
        T = np.eye(4)
        T[0, 3] = 0.2 * i
        rt.robot_state_callback(float(i), T, np.array([0.8, 0, 0, 0, 0, 0]), np.array([1.0, 0, 0, 0, 0, 0]))
    nodes = rt.estimator.get_supervision_nodes()
    assert len(nodes) >= 4
    tri = rt.export_supervision_markers(ply_path=str(tmp_path / "m.ply"), json_path=str(tmp_path / "m.json"))
    want = jvisu.build_footprint_ribbon(nodes)
    assert tri.num_triangles == want.num_triangles >= 2 * (len(nodes) - 1)
    assert json.loads((tmp_path / "m.json").read_text()) == json.loads(want.to_json())
    assert (tmp_path / "m.ply").read_text().startswith("ply\n")


def test_logger_panel_is_the_visualizer(tmp_path):
    """The postprocess logger stores visu/'s mission-node panel."""
    from PIL import Image

    rng = np.random.default_rng(2)
    img = rng.random((3, 16, 16)).astype(np.float32)
    trav, conf = rng.random((2, 16, 16)).astype(np.float32)
    lg = MissionLogger(folder=str(tmp_path))
    lg.log_inference(img, trav, conf, stamp=0.5)
    stored = np.asarray(Image.open(next((tmp_path / "images").glob("*.png"))))
    panel = jvisu.LearningVisualizer().plot_mission_node_prediction(img, trav, conf)
    np.testing.assert_array_equal(stored, (np.clip(panel, 0, 1) * 255).astype(np.uint8))


def test_golden_head_file_equals_the_jax_init():
    """assets/goldens/demo_mission_head_init_torch.npz holds exactly the
    head, confidence state and step of the golden's JAX runtime when it is
    built, so the file cannot go stale without this test failing."""
    sys.path.insert(0, ROOT)
    from tools.convert_golden_head_to_torch import golden_head_arrays

    want = golden_head_arrays()
    with np.load(demo_golden.HEAD) as z:
        assert set(z.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v)


def test_golden_replay_meets_the_golden_limits():
    """The demo mission through the port's runtime on the CPU from the
    committed initial head: train steps within max(2, golden // 10),
    traversability MAE < 0.05 and overlay MAE < 8.0 (uint8), the golden's
    own limits (tests/test_demo_assets.py). The JAX package on the same
    host reads a traversability MAE of 0.042 against this golden, which was
    recorded on another host; the port's maps are within 1e-4 MAE of the
    JAX package's here."""
    out = demo_golden.replay_against_golden("cpu")
    assert out["ok"], out
    assert out["train_steps"] == out["golden_train_steps"] and out["valid_nodes"] == out["golden_valid_nodes"]
