"""Vectorised hyperparameter search over the offline trainer.

Port of the repository's tools/param_search.py. The whole population trains
at once: every trial's (params, Adam moments, confidence state) is stacked
on a leading axis (`torch.func.stack_module_state`), per-trial
hyperparameters (lr, w_trav, w_reco) ride in as tensors, and one
`vmap(grad(...))` over `functional_call` advances every trial per batch. Adam
is written out on the stacked tensors in the algebra of `torch.optim.Adam`
(bias corrections, eps outside the square root), with each trial's lr.
The sampler is seeded quasi-random over the reference's own search space:

  lr       log-uniform [1e-4, 1e-2]
  w_trav   uniform [0, 1]
  w_reco   uniform [0, 1]     (w_temp stays 0, as in the reference's loss)
  anomaly_balanced categorical: a Python bool in the loss, so it forms an
           outer grid of populations rather than a vmapped axis

Trial 0 of the population that matches the production setting is pinned to
the production defaults (lr 1e-3, w_trav 0.03, w_reco 0.5) and starts from
the head `torch.Generator().manual_seed(seed)` draws, with the batch stream
of `np.random.RandomState(seed)`: its training is OfflineTrainer(seed)'s.
Trial i starts from seed + i. Selection metric: val AUROC.

Data sources:
  --data real            the reference's recorded mission graph
                         (offline/reference_graph.py)
  --data export:FOLDER   a TraversabilityEstimator.save_graph export
  --data synth           separable toy features

Usage:
  python -m wild_visual_navigation_tpu_torch.tools.param_search --data synth --trials 16 --epochs 10
  python -m wild_visual_navigation_tpu_torch.tools.param_search --data export:results/mission --device cpu
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np
import torch

from ..models.registry import get_model
from ..offline.dataset import GraphTravDataset
from ..offline.metrics import accuracy, auroc, optimal_threshold
from ..utils.confidence_generator import ConfidenceState, confidence_init
from ..utils.data import batch_from_arrays
from ..utils.devices import torch_device
from ..utils.loss import TraversabilityLossConfig, traversability_loss

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # make_adam's


def sample_space(n_trials: int, seed: int, pin_default: bool = True):
    """Seeded sample of the reference's search space; with pin_default,
    trial 0 is the production defaults (lr 1e-3, w_trav 0.03, w_reco 0.5).
    Pin only in the variant matching the production anomaly_balanced
    setting, so the other variant's coverage is not cut by a duplicate."""
    rng = np.random.RandomState(seed)
    lr = 10.0 ** rng.uniform(-4.0, -2.0, n_trials)
    w_trav = rng.uniform(0.0, 1.0, n_trials)
    w_reco = rng.uniform(0.0, 1.0, n_trials)
    if pin_default:
        lr[0], w_trav[0], w_reco[0] = 1e-3, 0.03, 0.5
    return lr, w_trav, w_reco


def population_fit(train, val, lr, w_trav, w_reco, *, epochs: int, batch_size: int, seed: int,
                   anomaly_balanced: bool = True, device="cuda", init_params: dict | None = None):
    """Train len(lr) trials at once; returns (scores (P, Nval), last-batch
    losses (P,), the stacked params {name: (P, ...)}). init_params, stacked
    the same way, replaces the trials' seeded heads."""
    from torch.func import functional_call, grad, stack_module_state, vmap

    dev = torch_device(device, "population_fit")
    P = len(lr)
    D = train.features.shape[-1]
    cfg = {"name": "SimpleMLP",
           "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1], "reconstruction": True}}
    # trial i's head is the one OfflineTrainer(seed + i) starts from
    n_built = 1 if init_params is not None else P
    models = [get_model(cfg, device=dev, generator=torch.Generator().manual_seed(seed + i)) for i in range(n_built)]
    base = models[0]
    if init_params is None:
        params = {k: v.detach() for k, v in stack_module_state(models)[0].items()}
    else:
        params = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev).clone()
                  for k, v in init_params.items()}
    exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
    exp_avg_sq = {k: torch.zeros_like(v) for k, v in params.items()}
    cg_state = ConfidenceState(*(t.expand((P,) + t.shape).clone() for t in confidence_init(dev)))
    lr64 = torch.as_tensor(np.asarray(lr, np.float64), device=dev)
    wt_v = torch.as_tensor(np.asarray(w_trav, np.float32), device=dev)
    wr_v = torch.as_tensor(np.asarray(w_reco, np.float32), device=dev)

    def loss_fn(p, cg, wt, wr, x, y, yv, sv):
        loss_cfg = TraversabilityLossConfig(w_trav=wt, w_reco=wr, w_temp=0.0, anomaly_balanced=anomaly_balanced)
        batch = batch_from_arrays(x, y, yv, sv)
        res = functional_call(base, p, (batch.x,))
        loss, _aux, cg2 = traversability_loss(loss_cfg, batch, res, cg)
        return loss, (loss.detach(), cg2)

    vgrad = vmap(grad(loss_fn, has_aux=True), in_dims=(0, 0, 0, 0, None, None, None, None))

    def expand(t, like):
        return t.reshape((P,) + (1,) * (like.ndim - 1))

    rng = np.random.RandomState(seed)  # OfflineTrainer.fit's shuffle stream
    losses, step = None, 0
    for _epoch in range(epochs):
        for batch in train.batches(batch_size, rng):
            x, y, yv, sv = (torch.as_tensor(np.asarray(a), device=dev) for a in batch)
            grads, (losses, cg_state) = vgrad(params, cg_state, wt_v, wr_v, x, y, yv, sv)
            step += 1
            bc1, bc2_sqrt = 1 - _B1**step, (1 - _B2**step) ** 0.5
            step_size = (lr64 / bc1).float()
            for k, g in grads.items():
                exp_avg[k] = torch.lerp(exp_avg[k], g, 1 - _B1)
                exp_avg_sq[k] = exp_avg_sq[k] * _B2 + (1 - _B2) * g * g
                denom = exp_avg_sq[k].sqrt() / bc2_sqrt + _EPS
                params[k] = params[k] - expand(step_size, g) * (exp_avg[k] / denom)

    with torch.no_grad():
        xv = torch.as_tensor(np.asarray(val.features), device=dev).float().reshape(-1, D)
        scores = vmap(lambda p: functional_call(base, p, (xv,))[:, 0])(params)
    losses = losses.cpu().numpy() if losses is not None else np.full(P, np.nan)
    return scores.cpu().numpy(), losses, params


def evaluate_population(scores: np.ndarray, val) -> list:
    labels = (val.signal.reshape(-1) > 0.5) & val.signal_valid.reshape(-1)
    mask = val.sample_valid.reshape(-1) & val.signal_valid.reshape(-1)
    rows = []
    for p in range(scores.shape[0]):
        s, l = scores[p][mask], labels[mask]
        if mask.sum() < 2 or len(np.unique(l)) < 2:
            rows.append({"val_auroc": float("nan"), "val_acc": float("nan")})
            continue
        thr = optimal_threshold(s, l)
        rows.append({"val_auroc": round(float(auroc(s, l)), 4),
                     "val_acc": round(float(accuracy(s, l, thr)), 4)})
    return rows


def make_synth(n_nodes: int = 64, n_seg: int = 8, dim: int = 32, seed: int = 0):
    """Linearly separable toy features: one generating hyperplane,
    temporally split into (train, val)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    total = 2 * n_nodes
    x = rng.randn(total, n_seg, dim).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    yv = rng.rand(total, n_seg) < 0.7
    sv = np.ones((total, n_seg), bool)

    def sub(sl):
        return GraphTravDataset(features=x[sl], signal=y[sl], signal_valid=yv[sl], sample_valid=sv[sl])

    return sub(slice(0, n_nodes)), sub(slice(n_nodes, total))


def load_real_folds(seed: int, k: int = 1):
    """The reference's recorded mission graph as (train, val) pairs.

    k == 1: one stratified 70/30 split. k > 1: stratified k-fold over the
    segments (per-trial val AUROC is then reported as mean +/- std over
    folds). Train side: y_valid marks the footprint-labelled segments (the
    rest enter through the confidence weighting, as online); val side: y
    is defined for every segment, so the metric scores the whole fold."""
    from ..offline import reference_graph as rg

    if not rg.available():
        raise SystemExit("--data real: reference graph assets not found")
    ref = rg.load_reference_graph()
    y, yv = ref.y, ref.y_valid
    S, _D = ref.x.shape

    def sub(sel, full_labels: bool):
        return GraphTravDataset(
            features=ref.x[sel][:, None, :],
            signal=y[sel][:, None].astype(np.float32),
            signal_valid=(np.ones((len(sel), 1), bool) if full_labels else yv[sel][:, None]),
            sample_valid=np.ones((len(sel), 1), bool),
        )

    rng = np.random.RandomState(seed)
    if k <= 1:
        split = int(S * 0.7)
        idx = rng.permutation(S)
        return [(sub(idx[:split], False), sub(idx[split:], True))]
    # stratified folds: positives spread round-robin
    pos = rng.permutation(np.flatnonzero(yv))
    neg = rng.permutation(np.flatnonzero(~yv))
    all_idx = np.arange(S)
    folds = []
    for f in range(k):
        va = np.sort(np.concatenate([pos[f::k], neg[f::k]]))
        tr = np.sort(np.setdiff1d(all_idx, va))
        folds.append((sub(tr, False), sub(va, True)))
    return folds


def load_data(spec: str, seed: int):
    if spec == "synth":
        return make_synth(seed=seed)
    if spec == "real":
        return load_real_folds(seed, k=1)[0]
    if spec.startswith("export:"):
        folder = spec.split(":", 1)[1]
        return (GraphTravDataset.from_folder(folder, "train", shuffle_seed=seed),
                GraphTravDataset.from_folder(folder, "val", shuffle_seed=seed))
    raise SystemExit(f"unknown --data {spec!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=str, default="real")
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--anomaly_balanced", type=str, default="both", choices=["both", "true", "false"])
    ap.add_argument("--kfold", type=int, default=5,
                    help="(--data real) stratified k-fold CV: per-trial val AUROC reported mean +/- std over "
                         "folds (1 = single 70/30 split)")
    ap.add_argument("--out", type=str, default="results/search_torch")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.data == "real" and args.kfold > 1:
        folds = load_real_folds(args.seed, k=args.kfold)
    else:
        folds = [load_data(args.data, args.seed)]
    variants = {"both": [True, False], "true": [True], "false": [False]}[args.anomaly_balanced]
    per_pop = max(2, args.trials // len(variants))

    production_ab = TraversabilityLossConfig().anomaly_balanced
    t0 = time.time()
    rows = []
    for ab in variants:
        # pin trial 0 to the production defaults only in the variant that
        # matches the production anomaly_balanced setting
        pin = ab == production_ab or len(variants) == 1
        lr, wt, wr = sample_space(per_pop, args.seed + int(ab), pin_default=pin)
        # the whole population trains once per fold; per-trial metrics
        # aggregate over folds
        per_fold_metrics, losses = [], None
        for train, val in folds:
            scores, losses, _ = population_fit(train, val, lr, wt, wr, epochs=args.epochs,
                                               batch_size=args.batch_size, seed=args.seed, anomaly_balanced=ab,
                                               device=args.device)
            per_fold_metrics.append(evaluate_population(scores, val))
        for i in range(per_pop):
            aurocs = [fm[i]["val_auroc"] for fm in per_fold_metrics if fm[i]["val_auroc"] == fm[i]["val_auroc"]]
            accs = [fm[i]["val_acc"] for fm in per_fold_metrics if fm[i]["val_acc"] == fm[i]["val_acc"]]
            rows.append({
                "trial": len(rows), "anomaly_balanced": ab,
                "lr": round(float(lr[i]), 6), "w_trav": round(float(wt[i]), 4),
                "w_reco": round(float(wr[i]), 4),
                "train_loss": float(f"{float(losses[i]):.3g}"),
                "is_default": i == 0 and pin and ab == production_ab,
                "val_auroc": round(float(np.mean(aurocs)), 4) if aurocs else float("nan"),
                "val_auroc_std": round(float(np.std(aurocs)), 4) if aurocs else float("nan"),
                "val_acc": round(float(np.mean(accs)), 4) if accs else float("nan"),
                "folds_valid": f"{len(aurocs)}/{len(folds)}",
            })
    wall = time.time() - t0

    rows_ranked = sorted(rows, key=lambda r: -(r["val_auroc"] if r["val_auroc"] == r["val_auroc"] else -1))
    best = rows_ranked[0]
    # the pinned production-default row exists unless the sweep was
    # restricted to the non-production anomaly_balanced variant
    default = next((r for r in rows if r["is_default"]), None)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "search_results.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows_ranked)
    summary = {"data": args.data, "trials": len(rows), "epochs": args.epochs, "device": args.device,
               "wall_s": round(wall, 1), "best": best, "default": default}
    with open(os.path.join(args.out, "search_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    md = [
        "# Hyperparameter search (vectorised population)",
        "",
        f"data={args.data}, {len(rows)} trials x {args.epochs} epochs in {wall:.1f}s on {args.device} "
        f"(all trials trained at once with torch.func.vmap).",
        "",
        "| rank | lr | w_trav | w_reco | anomaly_bal | val AUROC | +/- std | val acc | default |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rank, r in enumerate(rows_ranked[:10], 1):
        md.append(f"| {rank} | {r['lr']:.5f} | {r['w_trav']:.3f} | {r['w_reco']:.3f} "
                  f"| {r['anomaly_balanced']} | {r['val_auroc']} | {r.get('val_auroc_std', '-')} "
                  f"| {r['val_acc']} | {'*' if r['is_default'] else ''} |")
    md.append("")
    if default is not None:
        md.append(f"default config: AUROC {default['val_auroc']} (rank {1 + rows_ranked.index(default)}/{len(rows)})")
    with open(os.path.join(args.out, "search_results.md"), "w") as f:
        f.write("\n".join(md) + "\n")

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
