"""Offline training routine over exported mission graphs.

Port of wild_visual_navigation_tpu/offline/trainer.py: epochs of the
confidence-weighted traversability loss over a GraphTravDataset, validation
ROC/AUC with Youden's threshold, best-checkpoint saving. The step is the
online estimator's: the head from models/registry.py, `traversability_loss`
with the confidence state carried across steps, autograd, and the
estimator's Adam (`make_adam`, the algebra of `optax.adam`). Batches come
from `np.random.RandomState(cfg.seed)` as in the JAX trainer, so both
trainers see the same batches in the same order.

Checkpoints are torch files (state dicts, the confidence state, Adam's
state, step, loss, threshold); the JAX trainer's flax bytes have no torch
reader. A JAX trainer's state comes across through
utils/params.py::train_state_from_jax (`train_state=`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..models.registry import apply_model, camel_to_snake, get_model
from ..traversability.estimator import adam_with_moments, make_adam
from ..utils.confidence_generator import ConfidenceState, confidence_init
from ..utils.data import batch_from_arrays
from ..utils.devices import torch_device
from ..utils.loss import TraversabilityLossConfig, traversability_loss
from .dataset import GraphTravDataset
from .metrics import accuracy, auroc, optimal_threshold

@dataclass
class OfflineTrainerConfig:
    model_cfg: dict = field(default_factory=lambda: {
        "name": "SimpleMLP",
        "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1], "reconstruction": True},
    })
    lr: float = 1e-3
    epochs: int = 10
    batch_size: int = 8
    seed: int = 42
    loss_cfg: TraversabilityLossConfig = field(default_factory=TraversabilityLossConfig)
    output_folder: Optional[str] = None


class OfflineTrainer:
    def __init__(self, cfg: OfflineTrainerConfig, device="cuda", train_state: Optional[dict] = None):
        """The head is drawn from `torch.Generator().manual_seed(cfg.seed)`,
        as the online estimator draws its own. `train_state` (the keyword
        arguments `utils/params.py::train_state_from_jax` returns: params,
        adam, cg_state, step) replaces the fresh state, so a JAX trainer's
        weights and moments carry over."""
        self.cfg = cfg
        self.device = torch_device(device, "OfflineTrainer")
        self.model = get_model(cfg.model_cfg, device=self.device, generator=torch.Generator().manual_seed(cfg.seed))
        self.optimizer = make_adam(self.model.parameters(), cfg.lr)
        self.cg_state = confidence_init(self.device)
        self.step = 0
        self.threshold = 0.5
        self.history: list = []
        if train_state is not None:
            self.adopt_train_state(**train_state)

    @property
    def input_size(self) -> int:
        """The head's input width, from the model config."""
        return self.cfg.model_cfg[f"{camel_to_snake(self.cfg.model_cfg['name'])}_cfg"]["input_size"]

    def adopt_train_state(self, params: dict, adam: Optional[dict], cg_state: ConfidenceState,
                          step: Optional[int] = None):
        """Replace params (a state dict), Adam's moments ({"step",
        "exp_avg", "exp_avg_sq"} by param name; None for fresh ones), the
        confidence state and the step."""
        self.model.load_state_dict(params)
        self.optimizer = adam_with_moments(self.model, self.cfg.lr, adam)
        self.cg_state = ConfidenceState(*(t.to(self.device) for t in cg_state))
        if step is not None:
            self.step = step

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _train_step(self, x, y, yv, sv) -> torch.Tensor:
        batch = batch_from_arrays(*(self._tensor(a) for a in (x, y, yv, sv)))
        self.optimizer.zero_grad(set_to_none=True)
        res = apply_model(self.model, batch.x)
        loss, _aux, cg2 = traversability_loss(self.cfg.loss_cfg, batch, res, self.cg_state)
        loss.backward()
        self.optimizer.step()
        self.cg_state = cg2
        return loss.detach()

    @torch.no_grad()
    def predict(self, features) -> np.ndarray:
        """Traversability scores of (..., D) features, flattened, as numpy."""
        x = self._tensor(features).float()
        return apply_model(self.model, x.reshape(-1, self.input_size))[:, 0].cpu().numpy()

    def fit(self, train: GraphTravDataset, val: Optional[GraphTravDataset] = None, logger=None) -> Dict:
        rng = np.random.RandomState(self.cfg.seed)
        best_auc, best_path = -1.0, None
        for epoch in range(self.cfg.epochs):
            losses = []
            for x, y, yv, sv in train.batches(self.cfg.batch_size, rng):
                loss = self._train_step(x, y, yv, sv)
                self.step += 1
                losses.append(float(loss))
            row = {"epoch": epoch, "train_loss": float(np.mean(losses)) if losses else float("nan")}
            if val is not None and len(val):
                row.update(self.evaluate(val))
                if row["val_auroc"] > best_auc and self.cfg.output_folder:
                    best_auc = row["val_auroc"]
                    best_path = self.save(self.cfg.output_folder, "best.ckpt")
            self.history.append(row)
            if logger is not None:
                logger.log_metrics(row, step=self.step)
        out = dict(self.history[-1])
        out["best_checkpoint"] = best_path
        return out

    def evaluate(self, ds: GraphTravDataset) -> Dict:
        scores = self.predict(ds.features)
        labels = (ds.signal.reshape(-1) > 0.5) & ds.signal_valid.reshape(-1)
        mask = ds.sample_valid.reshape(-1) & ds.signal_valid.reshape(-1)
        if mask.sum() < 2 or len(np.unique(labels[mask])) < 2:
            return {"val_auroc": float("nan"), "val_acc": float("nan")}
        s, l = scores[mask], labels[mask]
        self.threshold = optimal_threshold(s, l)
        return {"val_auroc": auroc(s, l), "val_acc": accuracy(s, l, self.threshold)}

    def save(self, folder: str, name: str = "offline.ckpt") -> str:
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, name)
        torch.save({
            "params": self.model.state_dict(),
            "cg_state": self.cg_state._asdict(),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
            "loss": self.history[-1]["train_loss"] if self.history else float("inf"),
            "threshold": self.threshold,
        }, path)
        return path

    def load(self, path: str) -> dict:
        """Restore a checkpoint written by `save` onto this trainer's device;
        returns the payload's scalars (step, loss, threshold)."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["params"])
        self.optimizer = make_adam(self.model.parameters(), self.cfg.lr)
        self.optimizer.load_state_dict(payload["opt_state"])
        self.cg_state = ConfidenceState(**payload["cg_state"])
        self.step = payload["step"]
        self.threshold = payload["threshold"]
        return {k: payload[k] for k in ("step", "loss", "threshold")}
