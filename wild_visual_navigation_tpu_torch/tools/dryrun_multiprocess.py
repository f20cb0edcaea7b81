"""Multi-process dryrun: the estimator trained globally across processes.

Port of the repository's tools/dryrun_multiprocess.py. Spawns N ranks (one
per simulated camera group, torch.multiprocessing) joined into one Gloo
process group. Every rank:

  1. builds the estimator (tiny shapes, the same seed on every rank) and
     ingests its own camera group's mission nodes and supervision
     footprints locally;
  2. joins the collective `DistributedTrainer.step()` calls: the
     estimator's step on the concatenation of every rank's rows, the
     gradients summed over the ranks;
  3. writes the params back and prints a params checksum; then repeats
     with only rank 0 holding data (the others are starved and contribute
     fully-masked rows).

--runtime runs the whole runtime per rank instead of bare estimators: each
rank pumps its own synthetic camera sequence through WVNRuntime (image
callbacks, rate gates, supervision, the hot-swap cadence) with
attach_distributed_trainer, so every learning tick is the collective step;
--tp 2 splits the head over a ("dp", "tp") mesh. After a final hot swap a
frame must still give a finite traversability map.

The parent checks that every rank finished and printed the same checksum,
then prints "replicated state consistent". Exit code 0 = OK.

Usage:
  python -m wild_visual_navigation_tpu_torch.tools.dryrun_multiprocess --procs 2 --device cpu
  python -m wild_visual_navigation_tpu_torch.tools.dryrun_multiprocess --procs 2 --runtime --tp 2 --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _feed(est, rank: int, rng, y_offset: float) -> None:
    """One camera group's mission nodes and footprints, 10 m apart per rank."""
    from ..traversability.nodes import MissionNode, SupervisionNode

    S, D, H = est._S, est._D, est._H
    K = np.array([[40.0, 0, H / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    down = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    for i in range(6):
        pose = np.eye(4)
        pose[0, 3], pose[1, 3], pose[2, 3] = i * 0.5, y_offset, 1.5
        pose[:3, :3] = down
        node = MissionNode(timestamp=float(i), pose_base_in_world=pose, pose_cam_in_base=np.eye(4),
                           camera_name=f"cam{rank}")
        est.add_mission_node(node, rng.randn(S, D).astype(np.float32), np.ones(S, bool),
                             (np.arange(H * H) % S).reshape(H, H).astype(np.int32), K)
    for i in range(8):
        pose = np.eye(4)
        pose[0, 3], pose[1, 3] = i * 0.3, y_offset
        est.add_supervision_node(SupervisionNode(
            timestamp=float(i) + 0.1, pose_base_in_world=pose, pose_footprint_in_base=np.eye(4),
            twist_in_base=np.array([0.5, 0, 0, 0, 0, 0.0]), desired_twist_in_base=np.array([0.5, 0, 0, 0, 0, 0.0]),
            length=0.8, width=0.4, height=0.2, traversability=0.8, traversability_var=0.1, is_untraversable=False))


def _estimator(device: str, seed: int, sampling_seed: int):
    from ..traversability.estimator import TraversabilityEstimator

    S, D, H = 16, 32, 32
    return TraversabilityEstimator(
        model_cfg={"name": "SimpleMLP",
                   "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [64, 1], "reconstruction": True}},
        num_segments=S, feature_dim=D, image_height=H, image_width=H, buffer_capacity=16, reprojection_fanout=8,
        batch_size=4, min_samples_for_training=2, seed=seed, sampling_seed=sampling_seed, device=device)


def _checksum(est) -> float:
    from ..runtime.mesh_scenario import params_checksum

    return params_checksum(est.params)


def estimator_rank(rank: int, world: int, device: str) -> str:
    """Phases 1 and 2 on one rank; returns its report line."""
    from ..parallel import DistributedTrainer

    rng = np.random.RandomState(100 + rank)
    # the same head seed on every rank (the same initial head); each rank samples its own rows
    est = _estimator(device, seed=42, sampling_seed=7 + rank)
    _feed(est, rank, rng, 10.0 * rank)
    trainer = DistributedTrainer(est)
    for _ in range(5):
        last = trainer.step()
    trainer.sync_to_estimator()
    assert np.isfinite(last["loss_total"]), last
    assert est.step == 5

    # starvation: a camera group with no trainable data still joins every
    # step (fully-masked rows), and the state stays replicated
    est2 = _estimator(device, seed=43, sampling_seed=7 + rank)
    if rank == 0:
        _feed(est2, rank, rng, 0.0)
    trainer2 = DistributedTrainer(est2)
    for _ in range(3):
        last2 = trainer2.step()
    trainer2.sync_to_estimator()
    assert np.isfinite(last2["loss_total"]), last2
    line = (f"[rank {rank}] DISTRIBUTED OK loss={last['loss_total']:.6f} checksum={_checksum(est):.8f} "
            f"starved_checksum={_checksum(est2):.8f}")
    return line


def runtime_rank(rank: int, world: int, device: str, tp: int) -> str:
    """One camera group's whole runtime with its learning ticks joined into
    the collective step; returns its report line."""
    import torch

    from ..cfg.experiment import ExperimentParams
    from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from ..runtime import WVNRuntime, run_replay, synthetic_sequence

    size = 48
    fe = FeatureExtractorNodeParams(network_input_image_height=size, network_input_image_width=size,
                                    segmentation_type="grid", feature_type="sift", prediction_per_pixel=False,
                                    image_callback_rate=1000.0, grid_cell_size=8)
    ln = LearningNodeParams(network_input_image_height=size, network_input_image_width=size,
                            image_graph_dist_thr=0.1, supervision_graph_dist_thr=0.05, min_samples_for_training=3,
                            supervision_callback_rate=1000.0,
                            load_save_checkpoint_rate=2.0)  # a hot swap every ~5 learning ticks
    exp = ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [32, 1]
    # the same seeds on every rank: the same initial head
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, seed=0, buffer_capacity=32, reprojection_fanout=8,
                    device=device)
    trainer = rt.attach_distributed_trainer(tp=tp)
    # each rank its own camera sequence, with the same event cadence: every
    # rank reaches the (collective) learning ticks in lockstep
    seq = synthetic_sequence(duration=4.0, frame_rate=5.0, state_rate=5.0, image_size=size, seed=100 + rank)
    report = run_replay(rt, seq, train_every_state=1)
    assert report.frames_processed > 3, f"rank {rank}: the runtime processed too few frames"
    assert trainer.step_count >= 15, trainer.step_count
    rt.hot_swap()  # the trained params into the local estimator and the mailbox

    # a frame through the swapped params gives a finite map
    frame = seq.frames[-1]
    res = rt.image_callback(frame.image, frame.stamp + 100.0, frame.camera, frame.K, frame.image.shape[1],
                            frame.image.shape[2], frame.pose_base_in_world, frame.pose_cam_in_base)
    assert res is not None, f"rank {rank}: the frame after training was gated"
    trav = res.traversability
    assert bool(torch.isfinite(trav).all()) and tuple(trav.shape) == (size, size)
    line = (f"[rank {rank}] RUNTIME OK steps={trainer.step_count} frames={report.frames_processed} "
            f"loss={report.final_loss:.6f} mesh={tuple(trainer.mesh.mesh_dim_names)} tp={tp} "
            f"checksum={_checksum(rt.estimator):.8f}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--runtime", action="store_true", help="drive the whole WVNRuntime per rank")
    ap.add_argument("--tp", type=int, default=1, help="(--runtime) tensor-parallel degree of the head")
    ap.add_argument("--device", default="cuda", help="cuda (every rank on this machine's card) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    from ..parallel.launch import run_ranks
    from ..utils.devices import torch_device

    torch_device(args.device, "dryrun_multiprocess")
    if args.runtime:
        lines = run_ranks(runtime_rank, args.procs, args=(args.device, args.tp), timeout=args.timeout)
    else:
        lines = run_ranks(estimator_rank, args.procs, args=(args.device,), timeout=args.timeout)
    checksums = [line.split("checksum=", 1)[1] for line in lines]
    for line in lines:
        print(line)
    if len(set(checksums)) != 1:
        print(f"checksum mismatch across ranks: {checksums}")
        return 1
    mode = "runtime" if args.runtime else "estimator"
    print(f"multiprocess {mode} dryrun OK: {args.procs} procs on {args.device} (gloo), "
          "replicated state consistent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
