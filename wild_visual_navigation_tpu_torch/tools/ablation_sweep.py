"""Feature x segmentation ablation harness.

Port of the repository's tools/ablation_sweep.py, the analogue of the
reference paper's ablation script. For each (segmentation_type,
feature_type) combination it

  1. runs the online loop (WVNRuntime through runtime/replay.py::run_replay)
     on a synthetic replay world with that extractor configuration,
     generating self-supervised labels;
  2. exports the mission graph (TraversabilityEstimator.save_graph);
  3. trains the offline trainer (offline/trainer.py) with k-fold CV over
     the exported nodes, beside a label-shuffle control trained the same
     way, and records val AUROC / accuracy / loss.

One command -> results table (CSV + markdown) under --out:

    python -m wild_visual_navigation_tpu_torch.tools.ablation_sweep [--combos grid:sift,grid:histogram]
        [--duration 10] [--size 64] [--out results/ablations_torch] [--device cpu]

Backbone weights are seeded random (no checkpoint is in the repository), so
absolute AUCs of the dino and torchvision rows are not comparable with the
paper's; the table's use is relative.

The offline stage uses the reference's feature-ablation loss config
(w_reco=0, anomaly_balanced=False: the pure supervised traversability
loss), not the online loss, whose reconstruction gradient starves the
traversability head on high-dimensional features. Every row also reports
the label-shuffle control it must beat.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import sys
import time

import numpy as np

from ..cfg.experiment import ExperimentParams
from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from ..offline.dataset import GraphTravDataset
from ..offline.trainer import OfflineTrainer, OfflineTrainerConfig
from ..runtime import WVNRuntime, run_replay, synthetic_sequence
from ..utils.devices import torch_device

DEFAULT_COMBOS = "grid:sift,grid:histogram,slic:sift,grid:dinov2,grid:torchvision"
ROW_KEYS = ["segmentation", "feature", "feature_dim", "nodes_exported", "online_train_steps", "folds_valid",
            "val_auroc", "val_auroc_std", "val_acc", "control_auroc", "control_auroc_std", "train_loss", "wall_s"]


def run_one(seg: str, feat: str, args) -> dict:
    """One combination: replay, export to args.out/exports/{seg}_{feat},
    k-fold offline training with its control. args carries size, duration,
    epochs, kfold, out and device."""
    size = args.size
    fe = FeatureExtractorNodeParams(
        network_input_image_height=size, network_input_image_width=size,
        segmentation_type=seg, feature_type=feat, prediction_per_pixel=False,
        image_callback_rate=1000.0, grid_cell_size=max(8, size // 8),
        slic_num_components=32, dino_backbone="vit_small",
        dino_patch_size=14 if feat == "dinov2" else 8,
    )
    ln = LearningNodeParams(
        network_input_image_height=size, network_input_image_width=size,
        image_graph_dist_thr=0.15, supervision_graph_dist_thr=0.05,
        min_samples_for_training=4, supervision_callback_rate=1000.0,
        robot_width=0.8, robot_length=0.8, traversability_radius=4.0,
    )
    exp = ExperimentParams()
    exp.model.simple_mlp_cfg.hidden_sizes = [64, 32, 1]
    t0 = time.time()
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, seed=0, buffer_capacity=128,
                    reprojection_fanout=16, device=args.device)
    seq = synthetic_sequence(duration=args.duration, frame_rate=5.0, state_rate=5.0, image_size=size, seed=0,
                             obstacle_x=6.0)
    report = run_replay(rt, seq, train_every_state=4)

    export = os.path.join(args.out, "exports", f"{seg}_{feat}")
    rt.estimator.save_graph(export)

    # k-fold CV over the exported nodes: per fold, train on K-1 folds and
    # score the held fold, beside a label-shuffle control trained the same
    # way; the table reports mean +/- std of both
    full = GraphTravDataset.from_folder(export, "train", percentage=1.0, shuffle_seed=None)
    D = full.features.shape[-1]
    N = len(full)
    cfg = OfflineTrainerConfig(epochs=args.epochs)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = D
    cfg.model_cfg["simple_mlp_cfg"]["hidden_sizes"] = [64, 32, 1]
    # the reference's feature-ablation loss config (module docstring)
    cfg.loss_cfg = dataclasses.replace(cfg.loss_cfg, w_reco=0.0, anomaly_balanced=False)

    K = max(2, args.kfold)
    perm = np.random.RandomState(0).permutation(N)
    aurocs, accs, controls, losses = [], [], [], []
    for f in range(K):
        va_idx = np.sort(perm[f::K])
        tr_idx = np.sort(np.setdiff1d(perm, va_idx))
        train, val = full.subset(tr_idx), full.subset(va_idx)
        res = OfflineTrainer(cfg, device=args.device).fit(train, val)
        ctrl = OfflineTrainer(cfg, device=args.device).fit(train.shuffled_labels(seed=1 + f), val)
        a = float(res.get("val_auroc", float("nan")))
        c = float(ctrl.get("val_auroc", float("nan")))
        if a == a and c == c:  # single-class val folds give nan: skipped
            aurocs.append(a)
            accs.append(float(res.get("val_acc", float("nan"))))
            controls.append(c)
            losses.append(float(res.get("train_loss", float("nan"))))

    def ms(v):
        return (round(float(np.mean(v)), 4), round(float(np.std(v)), 4)) if v else (float("nan"),) * 2

    am, astd = ms(aurocs)
    cm, cstd = ms(controls)
    return {
        "segmentation": seg,
        "feature": feat,
        "feature_dim": D,
        "nodes_exported": N,
        "online_train_steps": report.train_steps,
        "folds_valid": f"{len(aurocs)}/{K}",
        "val_auroc": am,
        "val_auroc_std": astd,
        "val_acc": ms(accs)[0],
        "control_auroc": cm,
        "control_auroc_std": cstd,
        "train_loss": round(float(np.mean(losses)), 4) if losses else float("nan"),
        "wall_s": round(time.time() - t0, 1),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--combos", type=str, default=DEFAULT_COMBOS, help="comma list of segmentation:feature pairs")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="replay length (s): longer -> more exported nodes -> bigger CV folds")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--kfold", type=int, default=5)
    ap.add_argument("--out", type=str, default="results/ablations_torch")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def sweep(args) -> list:
    """Every combination of args.combos; a combination that fails (a
    missing optional backbone) gives an `error` row and the sweep goes on.
    Writes the CSV and markdown tables under args.out; returns the rows.
    Without the card that args.device names it raises before the first row."""
    torch_device(args.device, "ablation_sweep")
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for combo in args.combos.split(","):
        seg, feat = combo.strip().split(":")
        print(f"=== ablation {seg}:{feat} ===", flush=True)
        try:
            rows.append(run_one(seg, feat, args))
        except Exception as e:  # a missing optional backbone must not end the sweep
            print(f"  FAILED: {e}", flush=True)
            rows.append({"segmentation": seg, "feature": feat, "error": str(e)[:120]})
        print(f"  {json.dumps(rows[-1])}", flush=True)

    with open(os.path.join(args.out, "ablation_results.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=ROW_KEYS + ["error"])
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(args.out, "ablation_results.md"), "w") as f:
        f.write(
            "Feature x segmentation ablation (wild_visual_navigation_tpu_torch.tools.ablation_sweep, "
            f"device {args.device}).\nThe offline stage runs the reference's feature-ablation loss config "
            "(w_reco=0, anomaly_balanced=False), not the online loss.\nBackbones are seeded random, so absolute "
            "AUCs are not comparable with the paper's.\nval_auroc / control_auroc are mean +/- std over k-fold "
            "CV (--kfold) on the exported nodes; the control is a label-shuffle trained identically per fold.\n"
            "An effect is real only when val_auroc clears control_auroc by more than their combined spread.\n\n"
        )
        f.write("| " + " | ".join(ROW_KEYS) + " |\n")
        f.write("|" + "---|" * len(ROW_KEYS) + "\n")
        for r in rows:
            f.write("| " + " | ".join(str(r.get(k, "-")) for k in ROW_KEYS) + " |\n")
    print(f"\nwrote {args.out}/ablation_results.{{csv,md}} ({len(rows)} rows)")
    return rows


def main(argv=None) -> int:
    sweep(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
