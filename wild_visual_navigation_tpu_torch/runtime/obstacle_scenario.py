"""The closed-loop obstacle scenario on the port: learn an obstacle from
proprioception, see it in the grid map, keep the carrot out of it.

The scenario of the JAX package's closed-loop test
(tests/test_closed_loop.py::test_closed_loop_learns_and_avoids_obstacle),
with that test's configuration (sift x grid at 64 px, a [64, 32, 1] head,
lr 3e-3, buffer 64, fan-out 16, grid 128 x 0.15) and its four checks:

  1. driven open loop through the obstacle, the robot crosses it
     (x > 3.2 m);
  2. it trains more than 100 steps on the way, from supervision that
     marks something untraversable (a signal below 0.4);
  3. after a consolidation of 300 steps and a second pass that rebuilds
     the grid map from the trained head without entering the obstacle, the
     obstacle's cell reads worse than the clean cell ahead by 0.15;
  4. the carrot is not inside the obstacle.

Then run_closed_loop drives 2 s more from there. `run_obstacle_scenario`
returns what each check measured and whether it held; the caller raises.
"""

from __future__ import annotations

import numpy as np

from ..cfg.experiment import ExperimentParams
from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from ..ops.gridmap import gridmap_init
from .replay import SimWorld, run_closed_loop
from .runtime import WVNRuntime

GRID_SIZE, GRID_RES = 128, 0.15
OBSTACLE_XY, CLEAN_XY = (2.5, 0.0), (1.7, 0.0)


def build_runtime(device="cuda", seed: int = 0) -> WVNRuntime:
    """The configuration the JAX package's learning-quality test proved
    learns the obstacle's appearance from proprioception alone."""
    fe = FeatureExtractorNodeParams(
        network_input_image_height=64, network_input_image_width=64, segmentation_type="grid", feature_type="sift",
        prediction_per_pixel=False, image_callback_rate=1000.0, grid_cell_size=8,
        camera_topics={"front": {"use_for_training": True}})
    ln = LearningNodeParams(
        network_input_image_height=64, network_input_image_width=64, image_graph_dist_thr=0.15,
        supervision_graph_dist_thr=0.05, min_samples_for_training=4, supervision_callback_rate=1000.0,
        robot_width=0.8, robot_length=0.8, traversability_radius=4.0)
    exp = ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [64, 32, 1]
    exp.optimizer.lr = 3e-3
    return WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, seed=seed, buffer_capacity=64,
                      reprojection_fanout=16, gridmap_size=GRID_SIZE, gridmap_resolution=GRID_RES, device=device)


def run_obstacle_scenario(rt: WVNRuntime) -> dict:
    world = SimWorld(image_size=64, obstacle_xy=OBSTACLE_XY, obstacle_radius=0.6, grind_factor=0.25, seed=1)

    def tick(cmd, train_steps=4):
        pose = world.pose()
        rt.image_callback(world.render(pose), world.t, "front", world.K, 64, 64, pose, world.pose_cam_in_base)
        achieved = world.step(cmd, 1.0 / 6.0)
        rt.robot_state_callback(world.t, world.pose(), achieved, cmd)
        for _ in range(train_steps):
            rt.learning_step()

    # phase 1: open loop straight through the obstacle
    cmd = np.array([1.0, 0, 0, 0, 0, 0.0])
    while world.t < 16.0 and world.x < 4.5:
        tick(cmd)
    crossed_x, steps = world.x, rt.estimator.step
    buf = rt.estimator.buffer
    sig = buf.signal[buf.signal_valid]
    min_signal = float(sig.min()) if sig.numel() else float("nan")

    # consolidation: the learning thread keeps training between missions
    for _ in range(300):
        rt.learning_step()

    # phase 2: rebuild the grid map from the trained head, re-observing the approach
    rt.gridmap = gridmap_init(GRID_SIZE, GRID_RES, device=rt.gridmap.weight.device)
    world.x, world.y, world.yaw = 0.2, 0.0, 0.0
    while world.x < 1.6:
        tick(cmd, train_steps=0)
    gm = rt.gridmap
    value_sum, weight = (a.cpu().numpy() for a in (gm.value_sum, gm.weight))
    trav = value_sum / np.maximum(weight, 1e-6)

    def cell(xy):
        c = ((np.array(xy) - gm.origin_xy) / GRID_RES).astype(int)
        return c[1], c[0]

    o, c = cell(OBSTACLE_XY), cell(CLEAN_XY)
    observed = bool(weight[o] > 0 and weight[c] > 0)
    goal, _ = rt.get_carrot(yaw=world.yaw)

    # phase 3: the closed-loop API from the current pose
    path, goals = run_closed_loop(rt, world, duration=world.t + 2.0, rate=6.0)
    return {
        "crossed_x": float(crossed_x), "train_steps": int(steps), "min_signal": min_signal,
        "obstacle_trav": float(trav[o]), "clean_trav": float(trav[c]), "cells_observed": observed,
        "carrot": goal, "loop_ticks": len(path), "loop_goals": sum(g is not None for g in goals),
        "checks": {
            "crosses the obstacle": bool(crossed_x > 3.2),
            "more than 100 train steps": steps > 100,
            "low-traversability supervision": min_signal < 0.4,
            "obstacle cell worse than the clean cell by 0.15": bool(observed and trav[o] < trav[c] - 0.15),
            "carrot not inside the obstacle": not (goal is not None and world.in_obstacle(goal[0], goal[1])),
            "closed loop finite": len(path) > 8 and bool(np.isfinite(path).all()),
        },
    }
