"""Train and evaluate on the reference's recorded mission graph.

Port of the repository's tools/real_data_eval.py. The data is the
reference's stored mission graph (offline/reference_graph.py): 100 STEGO
segments from a forest mission with self-supervised footprint labels
(y == y_valid: the positives are the footprint segments, the rest are
unlabelled and enter only through the confidence weighting), plus the
reference model's own stored predictions on that graph. The graph's files
are read from this repository's `assets/graph/`; until they are there,
`main` prints so and exits 1.

Held-out evaluation (the primary table): the graph's nodes are its
segments, so a by-node split is a by-segment split. Two splits, each scoring
every row on the same val rows, models trained on the train side only:

  random    a stratified 70/30 segment split (seeded)
  spatial   the left half of the image trains, the right half evaluates
            (split at the median segment-centre x), and the reverse

  rows per split:
    reference_stored      AUROC of the reference's stored trav_pred
    tpu_offline_mlp       the offline SimpleMLP trained on the train rows
    tpu_online_estimator  the train rows through TraversabilityEstimator's
                          online train step
    tpu_offline_shuffled  control: train labels permuted within the train
                          side; its val AUROC must fall to about chance

(The row names are the JAX tool's, so the two tools' tables line up.)

K-fold: 5-fold stratified CV over segments; mean +/- std of val-fold AUROC
for the stored predictions, the MLP and the shuffle control.

Full-fit rows: trained and evaluated on all 100 segments (fit capacity, not
generalisation).

The visualizer goldens of the stored predictions are rendered under
`--out`/goldens; the JAX package's committed goldens are never written.

Usage: python -m wild_visual_navigation_tpu_torch.tools.real_data_eval [--out results/real_data_torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np
import torch

from ..models.registry import apply_model
from ..offline.dataset import GraphTravDataset
from ..offline.metrics import accuracy, auroc, optimal_threshold
from ..offline.reference_graph import available, load_reference_graph, reference_confidence
from ..offline.trainer import OfflineTrainer, OfflineTrainerConfig
from ..traversability.estimator import TraversabilityEstimator
from ..traversability.nodes import MissionNode
from ..utils.devices import torch_device


def _auroc(scores, labels) -> float:
    return float(auroc(np.asarray(scores), np.asarray(labels)))


def eval_row(name: str, scores: np.ndarray, labels: np.ndarray, extra=None) -> dict:
    thr = optimal_threshold(scores, labels)
    row = {"model": name, "auroc": round(_auroc(scores, labels), 4),
           "acc_opt": round(float(accuracy(scores, labels, thr)), 4)}
    row.update(extra or {})
    return row


# --------------------------------------------------------------- training
def train_offline(x, y, y_valid, epochs: int = 60, seed: int = 0, device="cuda", train_state: dict | None = None):
    """The offline trainer on (x, y, y_valid) segments-as-samples; returns
    (trainer, score_fn) where score_fn maps features -> traversability
    scores. train_state (utils/params.py::train_state_from_jax) replaces the
    seeded head."""
    S, D = x.shape
    ds = GraphTravDataset(
        features=x[:, None, :],
        signal=y[:, None].astype(np.float32),
        signal_valid=y_valid[:, None],
        sample_valid=np.ones((S, 1), bool),
    )
    cfg = OfflineTrainerConfig(epochs=epochs, seed=seed)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = D
    trainer = OfflineTrainer(cfg, device=device, train_state=train_state)
    trainer.fit(ds)
    return trainer, trainer.predict


def train_online(x, y, y_valid, steps: int = 400, nodes: int = 10, seed: int = 0, device="cuda",
                 train_state: dict | None = None):
    """Push segments through TraversabilityEstimator's train step: the S
    train segments go into `nodes` mission nodes (a fixed permutation spreads
    the footprint labels across them) through add_mission_node, the
    fixture's supervision signal is written into the ring buffer (the
    fixture carries no poses, so reprojection is bypassed: the signal is
    what it would have produced), then `steps` calls of train(). Returns
    (estimator, score_fn, losses). train_state
    (utils/params.py::train_state_from_jax) replaces the seeded head."""
    dev = torch_device(device, "train_online")
    S, D = x.shape
    per = S // nodes
    perm = np.random.RandomState(seed).permutation(S)

    est = TraversabilityEstimator(
        model_cfg={"name": "SimpleMLP",
                   "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1], "reconstruction": True}},
        buffer_capacity=nodes,
        num_segments=per,
        feature_dim=D,
        image_height=8,
        image_width=8,
        min_samples_for_training=5,
        batch_size=8,
        seed=seed,
        device=dev,
    )
    if train_state is not None:
        est.adopt_train_state(**train_state)

    seg = np.zeros((8, 8), np.int32)
    K = np.eye(3, dtype=np.float32)
    sig = np.zeros((nodes, per), np.float32)
    sigv = np.zeros((nodes, per), bool)
    for i in range(nodes):
        sel = perm[i * per : (i + 1) * per]
        pose = np.eye(4)
        pose[0, 3] = i * 1.0  # spread out past the distance gate
        node = MissionNode(timestamp=float(i), pose_base_in_world=pose)
        ok = est.add_mission_node(node, x[sel], np.ones(per, bool), seg, K)
        assert ok, f"node {i} rejected by the distance gate"
        sig[node.buffer_slot] = y[sel]
        sigv[node.buffer_slot] = y_valid[sel]
        node._has_supervision = True

    with est.lock:
        est.buffer.signal.copy_(torch.as_tensor(sig, device=dev))
        est.buffer.signal_valid.copy_(torch.as_tensor(sigv, device=dev))

    losses = []
    for _ in range(steps):
        r = est.train()
        if r.get("loss_total", -1) != -1:
            losses.append(r["loss_total"])

    @torch.no_grad()
    def score(feats: np.ndarray) -> np.ndarray:
        return apply_model(est.model, torch.as_tensor(np.asarray(feats, np.float32), device=dev))[:, 0].cpu().numpy()

    return est, score, losses


# ----------------------------------------------------------------- splits
def stratified_split(labels: np.ndarray, val_frac: float, seed: int):
    """Seeded (train_idx, val_idx) with the positive fraction kept on both
    sides."""
    rng = np.random.RandomState(seed)
    pos = rng.permutation(np.flatnonzero(labels))
    neg = rng.permutation(np.flatnonzero(~labels))
    n_pos_val = max(2, int(round(len(pos) * val_frac)))
    n_neg_val = max(2, int(round(len(neg) * val_frac)))
    val = np.concatenate([pos[:n_pos_val], neg[:n_neg_val]])
    train = np.concatenate([pos[n_pos_val:], neg[n_neg_val:]])
    return np.sort(train), np.sort(val)


def spatial_split(centers: np.ndarray, reverse: bool = False):
    """The left half of the image trains, the right half evaluates (or the
    reverse); both directions are reported, since the footprint path is not
    symmetric."""
    med_x = np.median(centers[:, 0])
    left = centers[:, 0] < med_x
    if reverse:
        return np.flatnonzero(~left), np.flatnonzero(left)
    return np.flatnonzero(left), np.flatnonzero(~left)


def stratified_kfold(labels: np.ndarray, k: int, seed: int):
    """Seeded k-fold with the positives spread round-robin across folds;
    yields (train_idx, val_idx) per fold."""
    rng = np.random.RandomState(seed)
    pos = rng.permutation(np.flatnonzero(labels))
    neg = rng.permutation(np.flatnonzero(~labels))
    folds = [np.concatenate([pos[f::k], neg[f::k]]) for f in range(k)]
    all_idx = np.arange(len(labels))
    for f in range(k):
        val = np.sort(folds[f])
        train = np.sort(np.setdiff1d(all_idx, val))
        yield train, val


# ------------------------------------------------------------- held-out
def evaluate_split(ref, split_name: str, tr, va, epochs: int, online_steps: int, seed: int = 0,
                   device="cuda") -> list:
    """All four rows scored on the same val rows; the models see train only."""
    labels = ref.y > 0.5
    rows = []

    def row(model_name, scores_va, extra=None):
        r = eval_row(model_name, scores_va, labels[va], extra)
        r.update(split=split_name, n_train=len(tr), n_val=len(va), val_pos=int(labels[va].sum()))
        rows.append(r)
        return r

    row("reference_stored", ref.trav_pred[va])
    _, score = train_offline(ref.x[tr], ref.y[tr], ref.y_valid[tr], epochs=epochs, seed=seed, device=device)
    row("tpu_offline_mlp", score(ref.x[va]))
    est, score_on, losses = train_online(ref.x[tr], ref.y[tr], ref.y_valid[tr], steps=online_steps, seed=seed,
                                         device=device)
    row("tpu_online_estimator", score_on(ref.x[va]),
        {"train_steps": est.step, "loss_last": round(float(losses[-1]), 4) if losses else None})
    # label-shuffle control: permute the train labels, evaluate unchanged
    perm = np.random.RandomState(123 + seed).permutation(len(tr))
    _, score_sh = train_offline(ref.x[tr], ref.y[tr][perm], ref.y_valid[tr][perm], epochs=epochs, seed=seed + 1,
                                device=device)
    row("tpu_offline_shuffled", score_sh(ref.x[va]))
    return rows


def evaluate_kfold(ref, k: int, epochs: int, seed: int = 0, device="cuda") -> dict:
    """k-fold CV: mean +/- std of val-fold AUROC per model; the shuffle band
    is the noise floor a ranking must clear."""
    labels = ref.y > 0.5
    per_model: dict = {"reference_stored": [], "tpu_offline_mlp": [], "tpu_offline_shuffled": []}
    for f, (tr, va) in enumerate(stratified_kfold(labels, k, seed)):
        per_model["reference_stored"].append(_auroc(ref.trav_pred[va], labels[va]))
        _, score = train_offline(ref.x[tr], ref.y[tr], ref.y_valid[tr], epochs=epochs, seed=seed + f, device=device)
        per_model["tpu_offline_mlp"].append(_auroc(score(ref.x[va]), labels[va]))
        perm = np.random.RandomState(1000 + f).permutation(len(tr))
        _, score_sh = train_offline(ref.x[tr], ref.y[tr][perm], ref.y_valid[tr][perm], epochs=epochs,
                                    seed=seed + 100 + f, device=device)
        per_model["tpu_offline_shuffled"].append(_auroc(score_sh(ref.x[va]), labels[va]))
    return {m: {"mean": round(float(np.mean(v)), 4), "std": round(float(np.std(v)), 4),
                "folds": [round(x, 4) for x in v]} for m, v in per_model.items()}


# -------------------------------------------------------------- goldens
def render_goldens(ref, folder: str):
    """The stored predictions, the labels and the reference's confidence
    drawn over the graph, as PNGs in `folder` (PIL is imported here)."""
    from PIL import Image

    from ..visu.visualizer import LearningVisualizer

    os.makedirs(folder, exist_ok=True)
    visu = LearningVisualizer()
    conf = reference_confidence(ref.reco_pred, ref.x)
    renders = {
        "trav_pred_graph": visu.plot_traversability_graph(ref.trav_pred, ref.edge_index, ref.centers, ref.img),
        "labels_graph": visu.plot_traversability_graph(ref.y, ref.edge_index, ref.centers, ref.img),
        "confidence_graph": visu.plot_traversability_graph(conf, ref.edge_index, ref.centers, ref.img),
    }
    for tag, arr in renders.items():
        Image.fromarray((arr * 255).astype(np.uint8)).save(os.path.join(folder, f"{tag}.png"))
    return renders


def _table(f, keys, rows):
    f.write("| " + " | ".join(keys) + " |\n")
    f.write("|" + "---|" * len(keys) + "\n")
    for r in rows:
        f.write("| " + " | ".join(str(r.get(k, "-")) for k in keys) + " |\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default="results/real_data_torch")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--online-steps", type=int, default=400)
    ap.add_argument("--kfold", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    torch_device(dev, "real_data_eval")

    if not available():
        print("reference graph assets not found; nothing to do")
        return 1

    ref = load_reference_graph()
    labels = ref.y > 0.5
    print(f"loaded real mission graph: {ref.num_segments} segments x {ref.feature_dim}-dim STEGO features, "
          f"{int(ref.y_valid.sum())} footprint-labeled (y == y_valid), {ref.edge_index.shape[1]} adjacency edges, "
          f"img {ref.img.shape}")

    # ---- held-out splits (the primary table)
    held_rows = []
    tr, va = stratified_split(labels, val_frac=0.3, seed=0)
    held_rows += evaluate_split(ref, "random", tr, va, args.epochs, args.online_steps, device=dev)
    tr, va = spatial_split(ref.centers)
    held_rows += evaluate_split(ref, "spatial", tr, va, args.epochs, args.online_steps, device=dev)
    tr, va = spatial_split(ref.centers, reverse=True)
    held_rows += evaluate_split(ref, "spatial_rev", tr, va, args.epochs, args.online_steps, device=dev)
    for r in held_rows:
        print("held-out:", r)

    # ---- k-fold
    kf = evaluate_kfold(ref, k=args.kfold, epochs=args.epochs, device=dev)
    print("kfold:", kf)

    # ---- full-fit rows (fit capacity, not generalisation)
    full_rows = []
    conf = reference_confidence(ref.reco_pred, ref.x)
    full_rows.append(eval_row("reference_stored", ref.trav_pred, labels,
                              {"conf_auroc": round(_auroc(conf, labels), 4)}))
    trainer, score = train_offline(ref.x, ref.y, ref.y_valid, epochs=args.epochs, device=dev)
    with torch.no_grad():
        our_reco = apply_model(trainer.model, torch.as_tensor(ref.x, device=trainer.device))[:, 1:].cpu().numpy()
    our_conf = reference_confidence(our_reco, ref.x)
    full_rows.append(eval_row("tpu_offline_mlp_fullfit", score(ref.x), labels,
                              {"conf_auroc": round(_auroc(our_conf, labels), 4)}))
    perm = np.random.RandomState(123).permutation(ref.num_segments)
    _, score_sh = train_offline(ref.x, ref.y[perm], ref.y_valid[perm], epochs=args.epochs, seed=1, device=dev)
    full_rows.append(eval_row("tpu_offline_shuffled_fullfit", score_sh(ref.x), labels))
    est, score_on, losses = train_online(ref.x, ref.y, ref.y_valid, steps=args.online_steps, device=dev)
    full_rows.append(eval_row("tpu_online_estimator_fullfit", score_on(ref.x), labels,
                              {"train_steps": est.step,
                               "loss_first": round(float(losses[0]), 4) if losses else None,
                               "loss_last": round(float(losses[-1]), 4) if losses else None}))
    for r in full_rows:
        print("full-fit:", r)

    # ---- artifacts
    os.makedirs(args.out, exist_ok=True)
    held_keys = ["split", "model", "auroc", "acc_opt", "n_train", "n_val", "val_pos", "train_steps", "loss_last"]
    with open(os.path.join(args.out, "real_data_heldout.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=held_keys)
        w.writeheader()
        w.writerows([{k: r.get(k, "") for k in held_keys} for r in held_rows])
    full_keys = ["model", "auroc", "acc_opt", "conf_auroc", "train_steps", "loss_first", "loss_last"]
    with open(os.path.join(args.out, "real_data_results.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=full_keys)
        w.writeheader()
        w.writerows([{k: r.get(k, "") for k in full_keys} for r in full_rows])
    with open(os.path.join(args.out, "real_data_kfold.json"), "w") as f:
        json.dump({"k": args.kfold, "epochs": args.epochs, "device": dev, "auroc": kf}, f, indent=1)
    with open(os.path.join(args.out, "real_data_results.md"), "w") as f:
        f.write("# Recorded-mission validation (wild_visual_navigation_tpu_torch.tools.real_data_eval)\n\n"
                f"Device {dev}. Held-out splits: models train on the train side only; every row, the "
                "reference's stored predictions included, is scored on the same val rows.\n\n")
        _table(f, held_keys, held_rows)
        f.write(f"\n## {args.kfold}-fold CV (val-fold AUROC, mean +/- std)\n\n| model | mean | std | folds |\n"
                "|---|---|---|---|\n")
        for m, v in kf.items():
            f.write(f"| {m} | {v['mean']} | {v['std']} | {v['folds']} |\n")
        f.write("\n## Full-graph fit (fit capacity only, not a generalisation claim)\n\n")
        _table(f, full_keys, full_rows)

    goldens = os.path.join(args.out, "goldens")
    render_goldens(ref, goldens)
    print(f"\nwrote {args.out}/real_data_heldout.csv, real_data_kfold.json, real_data_results.{{csv,md}} and "
          f"goldens under {goldens}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
