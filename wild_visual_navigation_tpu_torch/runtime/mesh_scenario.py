"""The multi-camera scenario that holds a meshed runtime to an unmeshed one.

The scenario of the JAX package's tests/_mesh_runtime_check.py as a
function: four cameras looking down from 2 m, their (4, 3, 40, 40) frames
(numpy's RandomState(0), brightened by 0.01 a step) through
`image_batch_callback` for 3 steps, each step followed by a robot state
0.2 m ahead of the cameras' first pose, then 5 `learning_step`s. The
learning node's gates are the check's own (2 valid nodes to train, graph
distances of 0.01 m), so 12 frames and 3 footprints are enough to train.

`scenario_params` gives the check's configuration (DINO ViT-S/8 on a grid
at 32 px) or, with `product=True`, the product's feature extractor (cfg/
defaults: ViT-S/8 at 224, SLIC 100, per-pixel prediction) with the same
learning gates. `run_mesh_scenario` returns what the check compares: each
step's traversability and confidence maps, the 5 losses, the head's params,
and a checksum of the params (sum of absolute values), which the ranks of
a mesh must agree on. `run_single_frame_scenario` sends the same cameras'
frames one at a time through `image_callback`, the route on which a tp mesh
runs its ViT on one frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams

CAMERAS = 4
TOLERANCES = {"trav_atol": 1e-2, "loss_rtol": 5e-2, "loss_atol": 5e-3, "params_atol": 1e-2}  # the check's


def scenario_params(product: bool = False):
    """(fe_params, ln_params) of the scenario: the check's grid at 32 px,
    or the product's feature extractor with `product=True`."""
    cams = {f"cam{i}": {"use_for_training": True} for i in range(CAMERAS)}
    if product:
        fe = FeatureExtractorNodeParams(image_callback_rate=1000.0, camera_topics=cams)
    else:
        fe = FeatureExtractorNodeParams(network_input_image_height=32, network_input_image_width=32,
                                        segmentation_type="grid", feature_type="dino", dino_backbone="vit_small",
                                        dino_patch_size=8, image_callback_rate=1000.0, camera_topics=cams,
                                        grid_cell_size=8)
    ln = LearningNodeParams(min_samples_for_training=2, image_graph_dist_thr=0.01, supervision_graph_dist_thr=0.01,
                            supervision_callback_rate=1000.0)
    return fe, ln


def scenario_inputs():
    """The frames, intrinsics and the camera's pose in the base."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(CAMERAS, 3, 40, 40).astype(np.float32)
    Ks = np.tile(np.array([[30.0, 0, 20], [0, 30, 20], [0, 0, 1]], np.float32), (CAMERAS, 1, 1))
    Tc = np.eye(4)
    Tc[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])  # looking down
    Tc[2, 3] = 2.0
    return imgs, Ks, Tc


def params_checksum(params: dict) -> float:
    """Sum of |value| over every parameter, in float64 on the host."""
    return float(sum(np.abs(v.detach().cpu().double().numpy()).sum() for v in params.values()))


def run_mesh_scenario(rt, steps: int = 3, n_train: int = 5) -> dict:
    """Drive the scenario through `rt`'s callbacks: {"trav": [(4, H, W)] per
    step, "conf": likewise, "losses": [n_train], "params": {name: numpy},
    "checksum": float}."""
    imgs, Ks, Tc = scenario_inputs()
    trav, conf = [], []
    for step in range(steps):
        poses = np.tile(np.eye(4), (CAMERAS, 1, 1))
        poses[:, 0, 3] = step * 0.5 + np.arange(CAMERAS) * 0.1
        res = rt.image_batch_callback(imgs + step * 0.01, stamps=[step + 0.1 * i for i in range(CAMERAS)],
                                      cameras=[f"cam{i}" for i in range(CAMERAS)], Ks=Ks, orig_h=40, orig_w=40,
                                      poses_base_in_world=poses, poses_cam_in_base=np.tile(Tc, (CAMERAS, 1, 1)))
        trav.append(torch.stack([r.traversability for r in res]).float().cpu().numpy())
        conf.append(torch.stack([r.confidence for r in res]).float().cpu().numpy())
        pT = np.eye(4)
        pT[0, 3] = step * 0.5 + 0.2
        rt.robot_state_callback(step + 0.5, pT, np.array([1.0, 0, 0, 0, 0, 0]), np.array([1.0, 0, 0, 0, 0, 0]))
    losses = [rt.learning_step().loss_total for _ in range(n_train)]
    params = rt.estimator.params
    return {"trav": trav, "conf": conf, "losses": losses,
            "params": {k: v.detach().cpu().clone().numpy() for k, v in params.items()},
            "checksum": params_checksum(params)}


def run_single_frame_scenario(rt, steps: int = 2) -> dict:
    """The scenario's frames through `image_callback`, one camera at a
    time, for `steps` steps: {"trav": [(H, W)] per call, "conf": likewise,
    "features": the mission buffer's features afterwards}."""
    imgs, Ks, Tc = scenario_inputs()
    trav, conf = [], []
    for step in range(steps):
        for i in range(CAMERAS):
            pose = np.eye(4)
            pose[0, 3] = step * 0.5 + i * 0.1
            res = rt.image_callback(imgs[i] + step * 0.01, step + 0.1 * i, f"cam{i}", Ks[i], 40, 40, pose, Tc)
            trav.append(res.traversability.float().cpu().numpy())
            conf.append(res.confidence.float().cpu().numpy())
    return {"trav": trav, "conf": conf, "features": rt.estimator.buffer.features.float().cpu().numpy()}
