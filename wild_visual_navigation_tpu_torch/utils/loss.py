"""Confidence-weighted traversability and anomaly losses.

Port of wild_visual_navigation_tpu/utils/loss.py. The confidence
generator's state goes in and comes out explicitly; boolean indexing is
written as masked reductions, so shapes stay fixed.

    loss_reco_i = mean_d (reco_i - x_i)^2                 per sample
    confidence  = confidence_update(loss_reco, positives=labelled), no grad
    loss_trav_i = (trav_i - y_i)^2         (or binary cross-entropy)
    loss_trav   = (sum_labelled + sum_unlabelled * (1 - conf)) / N
    loss        = w_trav * loss_trav + w_reco * mean_labelled(loss_reco)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from .confidence_generator import ConfidenceConfig, ConfidenceState, confidence_inference, confidence_update
from .data import TravBatch


@dataclass(frozen=True)
class TraversabilityLossConfig:
    w_trav: float = 0.03
    w_reco: float = 0.5
    w_temp: float = 0.0  # the reference computes the temporal term as 0
    anomaly_balanced: bool = True
    trav_cross_entropy: bool = False
    confidence: ConfidenceConfig = ConfidenceConfig()


def _masked_mean(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    mf = m.to(v.dtype)
    return torch.sum(v * mf) / torch.clamp_min(torch.sum(mf), 1.0)


def traversability_loss(
    cfg: TraversabilityLossConfig,
    batch: TravBatch,
    res: torch.Tensor,
    cg_state: ConfidenceState,
    update_generator: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], ConfidenceState]:
    """Loss on model output `res` (N, 1 + D) -> (loss, aux incl. the
    per-sample confidence, new confidence state). No gradient flows
    through the confidence statistics."""
    D = batch.x.shape[-1]
    reco = res[:, -D:]
    trav = res[:, 0]

    loss_reco = torch.mean((reco - batch.x) ** 2, dim=-1)  # (N,)
    labeled = batch.y_valid & batch.sample_valid
    unlabeled = (~batch.y_valid) & batch.sample_valid

    loss_reco_ng = loss_reco.detach()
    if update_generator:
        cg_state, confidence = confidence_update(cfg.confidence, cg_state, loss_reco_ng, labeled)
    else:
        confidence = confidence_inference(cfg.confidence, cg_state, loss_reco_ng)
    confidence = confidence.detach()

    if cfg.trav_cross_entropy:
        eps = 1e-7
        p = torch.clamp(trav, eps, 1 - eps)
        loss_trav_raw = -(batch.y * torch.log(p) + (1 - batch.y) * torch.log(1 - p))
    else:
        loss_trav_raw = (trav - batch.y) ** 2

    n = torch.clamp_min(torch.sum(batch.sample_valid.float()), 1.0)
    if cfg.anomaly_balanced:
        s_labeled = torch.sum(torch.where(labeled, loss_trav_raw, 0.0))
        s_unlabeled = torch.sum(torch.where(unlabeled, loss_trav_raw * (1.0 - confidence), 0.0))
        loss_trav_confidence = (s_labeled + s_unlabeled) / n
    else:
        loss_trav_confidence = _masked_mean(loss_trav_raw, batch.sample_valid)

    loss_reco_mean = _masked_mean(loss_reco, labeled)
    loss_temp = torch.zeros_like(loss_trav_confidence)
    loss = cfg.w_trav * loss_trav_confidence + cfg.w_reco * loss_reco_mean + cfg.w_temp * loss_temp

    aux = {
        "loss_reco": loss_reco_mean,
        "loss_trav": _masked_mean(loss_trav_raw, batch.sample_valid),
        "loss_temp": loss_temp,
        "loss_trav_confidence": loss_trav_confidence,
        "confidence": confidence,
    }
    return loss, aux, cg_state


@dataclass(frozen=True)
class AnomalyLossConfig:
    confidence: ConfidenceConfig = ConfidenceConfig()


def anomaly_loss(
    cfg: AnomalyLossConfig,
    res: Dict[str, torch.Tensor],
    sample_valid: torch.Tensor,
    cg_state: ConfidenceState,
    update_generator: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], ConfidenceState]:
    """Flow negative log-likelihood + confidence update.
    res: {"logprob": (N, D), "log_det": (N,)}; sample_valid: (N,) bool."""
    losses = torch.sum(res["logprob"], dim=-1) + res["log_det"]  # (N,) log-likelihoods
    neg = (-losses).detach()
    if update_generator:
        cg_state, confidence = confidence_update(cfg.confidence, cg_state, neg, sample_valid)
    else:
        confidence = confidence_inference(cfg.confidence, cg_state, neg)
    loss = -_masked_mean(losses, sample_valid)
    zero = torch.zeros((), device=losses.device)
    return loss, {"loss_trav": zero, "loss_reco": zero, "confidence": confidence}, cg_state


def reconstruction_confidence(
    cfg: ConfidenceConfig,
    cg_state: ConfidenceState,
    features: torch.Tensor,
    reconstruction: torch.Tensor,
) -> torch.Tensor:
    """Per-sample confidence from the reconstruction error, without
    updating the statistics (the inference path)."""
    loss_reco = torch.mean((reconstruction - features) ** 2, dim=-1)
    return confidence_inference(cfg, cg_state, loss_reco)
