"""The whole port in ~50 lines: online self-supervised traversability
learning on a synthetic drive, through the PyTorch port's WVNRuntime (the
counterpart of examples/minimal_online_loop.py).

    camera frames -> fused frozen-backbone inference -> mission graph
    robot state   -> supervision (velocity tracking)  -> reprojection
    train step    -> confidence-weighted loss -> hot-swapped weights

Run (the card by default; --device cpu on a machine without one):
    python -m wild_visual_navigation_tpu_torch.examples.minimal_online_loop [--device cpu]
"""

import argparse
import tempfile

from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, run_replay, synthetic_sequence


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=112)
    args = ap.parse_args(argv)

    # 1. Configure: the knobs of the reference's default.yaml, as dataclasses.
    fe = FeatureExtractorNodeParams(
        network_input_image_height=args.size,
        network_input_image_width=args.size,
        segmentation_type="grid",      # or "slic", "none"
        feature_type="dino",           # or "dinov2"
        dino_backbone="vit_small",
        dino_patch_size=8,
        image_callback_rate=1000.0,    # no rate gating for the demo
    )
    ln = LearningNodeParams(min_samples_for_training=4, image_graph_dist_thr=0.1, supervision_callback_rate=1000.0)

    # 2. Build the runtime: frozen ViT + traversability head + confidence,
    #    mission/supervision graphs, the fused frame.
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=ExperimentParams(), seed=0,
                    buffer_capacity=32, reprojection_fanout=8, device=args.device)

    # 3. Drive it: synthetic_sequence stands in for a rosbag (timestamped
    #    frames + robot state); runtime.replay.load_sequence reads a recorded one.
    seq = synthetic_sequence(duration=6.0, frame_rate=5.0, state_rate=10.0, image_size=args.size, seed=0)
    report = run_replay(rt, seq, train_every_state=1, verbose=False)

    print(f"frames processed: {report.frames_processed}")
    print(f"supervision updates: {report.supervision_updates}")
    print(f"train steps: {report.train_steps}  final loss: {report.final_loss:.4f}")

    # 4. The reference's services are a method away.
    ckpt = rt.save_checkpoint(tempfile.mkdtemp(prefix="wvn_demo_"), "demo.ckpt")
    print(f"checkpoint: {ckpt}")
    return report


if __name__ == "__main__":
    main()
