"""Online-learning demo on the PyTorch port: the counterpart of the
repository's demo_online.py.

Runs the full self-supervised loop through the port's WVNRuntime on a
synthetic replay (a robot driving over textured ground, with an optional
untraversable band where velocity tracking collapses), then writes:

  <out>/learning_curves.{csv,png}
  <out>/images/??????_*.png    (input | trav | confidence)
  <out>/footprints.ply         (the driven-footprint ribbon, visu/markers.py)

Usage:
    python -m wild_visual_navigation_tpu_torch.demo_online [--duration 12] [--size 224] [--obstacle_x 6.0]
                                                          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--seg", type=str, default="slic")
    ap.add_argument("--obstacle_x", type=float, default=None)
    ap.add_argument("--out", type=str, default="results/demo_online_torch")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .cfg.experiment import ExperimentParams
    from .cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from .runtime import WVNRuntime, synthetic_sequence
    from .scripts import MissionLogger

    fe = FeatureExtractorNodeParams(
        network_input_image_height=args.size, network_input_image_width=args.size,
        segmentation_type=args.seg, feature_type="dino", dino_patch_size=8,
        prediction_per_pixel=True, image_callback_rate=1e9,
    )
    ln = LearningNodeParams(
        network_input_image_height=args.size, network_input_image_width=args.size,
        image_graph_dist_thr=0.1, supervision_graph_dist_thr=0.05,
        min_samples_for_training=5, supervision_callback_rate=1e9,
        robot_width=0.6, robot_length=1.0,
    )
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=ExperimentParams(), seed=0, device=args.device)
    name = torch.cuda.get_device_name(0) if rt.estimator.buffer.features.is_cuda else "cpu"
    print(f"device: {name}; fused path: {rt._fused_frame is not None}")

    seq = synthetic_sequence(duration=args.duration, frame_rate=5.0, state_rate=5.0,
                             image_size=args.size, obstacle_x=args.obstacle_x)
    logger = MissionLogger(folder=args.out, store_images=True)

    last_result = None
    for stamp, kind, payload in seq.events():
        if kind == "frame":
            res = rt.image_callback(
                payload.image, payload.stamp, payload.camera, payload.K,
                payload.image.shape[1], payload.image.shape[2],
                payload.pose_base_in_world, payload.pose_cam_in_base,
            )
            if res is not None:
                last_result = (payload.image, res)
        else:
            rt.robot_state_callback(payload.stamp, payload.pose_base_in_world,
                                    payload.current_twist, payload.desired_twist)
            st = rt.learning_step()
            logger.log_system_state(st.step, st.loss_total, st.loss_trav, st.loss_reco,
                                    st.mission_graph_num_valid_node, stamp)
            if last_result is not None and int(stamp * 5) % 10 == 0:
                img, res = last_result
                trav, conf = res.to_numpy()
                logger.log_inference(img, trav, conf, stamp)
                last_result = None

    # the final frame is always logged
    if last_result is not None:
        img, res = last_result
        trav, conf = res.to_numpy()
        logger.log_inference(img, trav, conf, args.duration)

    csv = logger.store()
    png = logger.plot_learning_curves()
    tri = rt.export_supervision_markers(ply_path=f"{args.out}/footprints.ply")
    st = rt.system_state
    print(f"steps: {st.step}  valid nodes: {st.mission_graph_num_valid_node}  "
          f"loss: {st.loss_total:.4f} (trav {st.loss_trav:.4f} reco {st.loss_reco:.4f})")
    print(f"wrote {csv}\nwrote {png}\nimages under {args.out}/images")
    print(f"wrote {args.out}/footprints.ply ({tri.num_triangles} triangles)")
    return st


if __name__ == "__main__":
    main()
