"""Online confidence estimation over reconstruction losses.

Port of wild_visual_navigation_tpu/utils/confidence_generator.py. The
state is an explicit NamedTuple of tensors carried through the train
step. The four update methods of the reference:
  * latest_measurement (default): mean / std of this step's positives;
  * running_mean: accumulators over every positive seen;
  * kalman_filter: KF-smoothed mean with a gaussian falloff;
  * moving_average: statistics over the last 5 positive batches, kept
    as per-batch (sum, sum of squares, count) in a ring.
A step with no positive sample keeps the previous statistics, for every
method (for moving_average: the ring neither writes nor advances).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from .kalman_filter import KalmanFilterParams, KalmanState, kf_step

_WINDOW = 5  # moving_average window size


class ConfidenceState(NamedTuple):
    mean: torch.Tensor  # ()
    var: torch.Tensor  # ()
    std: torch.Tensor  # ()
    running_n: torch.Tensor  # ()
    running_sum: torch.Tensor  # ()
    running_sum2: torch.Tensor  # ()
    window_sum: torch.Tensor  # (W,)
    window_sum2: torch.Tensor  # (W,)
    window_n: torch.Tensor  # (W,)
    window_ptr: torch.Tensor  # () int32
    kf_cov: torch.Tensor  # ()


def confidence_init(device=None) -> ConfidenceState:
    def full(value, shape=(), dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return ConfidenceState(
        mean=full(0.0),
        var=full(1.0),
        std=full(1.0),
        running_n=full(0.0),
        running_sum=full(0.0),
        running_sum2=full(0.0),
        window_sum=full(0.0, (_WINDOW,)),
        window_sum2=full(0.0, (_WINDOW,)),
        window_n=full(0.0, (_WINDOW,)),
        window_ptr=full(0, dtype=torch.int32),
        kf_cov=full(1.0),
    )


@dataclass(frozen=True)
class ConfidenceConfig:
    std_factor: float = 0.7
    method: str = "latest_measurement"

    def __post_init__(self):
        if self.method not in ("latest_measurement", "running_mean", "kalman_filter", "moving_average"):
            raise ValueError(f"Unknown method {self.method}")


def confidence_inference(cfg: ConfidenceConfig, state: ConfidenceState, x: torch.Tensor) -> torch.Tensor:
    """Clip x to [max(shifted_mean - std, 0), shifted_mean + std] and map
    it linearly to 1 -> 0, with shifted_mean = mean + std · std_factor."""
    shifted_mean = state.mean + state.std * cfg.std_factor
    interval_min = torch.clamp_min(shifted_mean - state.std, 0.0)
    interval_max = shifted_mean + state.std
    xc = torch.minimum(torch.maximum(x, interval_min), interval_max)
    width = torch.clamp_min(interval_max - interval_min, 1e-12)
    return (1.0 - (xc - interval_min) / width).float()


def _masked_stats(x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, unbiased std, count) over the masked entries."""
    m = mask.float()
    n = torch.sum(m)
    mean = torch.sum(x * m) / torch.clamp_min(n, 1.0)
    var = torch.sum(((x - mean) ** 2) * m) / torch.clamp_min(n - 1.0, 1.0)
    return mean, torch.sqrt(var), n


def confidence_update(
    cfg: ConfidenceConfig,
    state: ConfidenceState,
    x: torch.Tensor,
    pos_mask: torch.Tensor,
) -> Tuple[ConfidenceState, torch.Tensor]:
    """One update step; returns (new_state, per-sample confidence of x).

    x: (N,) losses (padded; pass them detached); pos_mask: (N,) bool, the
    positive (footprint-labelled, non-padding) samples the statistics are
    fit to."""
    mean_p, std_p, n_p = _masked_stats(x, pos_mask)
    has_pos = n_p > 0

    if cfg.method == "latest_measurement":
        new_mean = torch.where(has_pos, mean_p, state.mean)
        new_std = torch.where(has_pos, std_p, state.std)
        state = state._replace(mean=new_mean, std=new_std, var=new_std**2)
        return state, confidence_inference(cfg, state, x)

    pos_sum = torch.sum(torch.where(pos_mask, x, 0.0))
    pos_sum2 = torch.sum(torch.where(pos_mask, x * x, 0.0))

    if cfg.method == "running_mean":
        rn = state.running_n + n_p
        rs = state.running_sum + pos_sum
        rs2 = state.running_sum2 + pos_sum2
        mean = rs / torch.clamp_min(rn, 1.0)
        var = torch.clamp_min(rs2 / torch.clamp_min(rn, 1.0) - mean**2, 0.0)
        state = state._replace(running_n=rn, running_sum=rs, running_sum2=rs2, mean=mean, var=var,
                               std=torch.sqrt(var))
        return state, confidence_inference(cfg, state, x)

    if cfg.method == "kalman_filter":
        # the reference's filter: process cov 0.2, measurement cov 1.0
        kfp = KalmanFilterParams.make(1, proc_cov=0.2, meas_cov=1.0, device=x.device)
        ks = kf_step(kfp, KalmanState(x=state.mean[None], P=state.kf_cov[None, None]), mean_p[None])
        new_mean = torch.where(has_pos, ks.x[0], state.mean)
        new_cov = torch.where(has_pos, ks.P[0, 0], state.kf_cov)
        new_std = torch.sqrt(new_cov)
        state = state._replace(mean=new_mean, kf_cov=new_cov, var=new_cov, std=new_std)
        conf = torch.exp(-(((x - new_mean) / (new_std * cfg.std_factor)) ** 2) * 0.5)
        conf = torch.where(x < new_mean, 1.0, conf)
        return state, conf.float()

    # moving_average: this batch's (sum, sum of squares, count) goes into
    # the ring slot at window_ptr, only when the batch has positives
    write = (torch.arange(_WINDOW, device=x.device) == state.window_ptr % _WINDOW) & has_pos
    wsum = torch.where(write, pos_sum, state.window_sum)
    wsum2 = torch.where(write, pos_sum2, state.window_sum2)
    wn = torch.where(write, n_p, state.window_n)
    n_tot = torch.sum(wn)
    mean = torch.sum(wsum) / torch.clamp_min(n_tot, 1.0)
    # unbiased (ddof=1), as torch.std over the concatenated window
    var = (torch.sum(wsum2) - n_tot * mean**2) / torch.clamp_min(n_tot - 1.0, 1.0)
    var = torch.clamp_min(var, 0.0)
    std = torch.sqrt(var)
    state = state._replace(window_sum=wsum, window_sum2=wsum2, window_n=wn,
                           window_ptr=state.window_ptr + has_pos.to(torch.int32), mean=mean, var=var, std=std)
    # clip to mean +- 2 std, then min-max normalise
    xc = torch.minimum(torch.maximum(x, mean - 2 * std), mean + 2 * std)
    lo, hi = torch.min(xc), torch.max(xc)
    return state, ((xc - lo) / torch.clamp_min(hi - lo, 1e-12)).float()


def confidence_reset(state: ConfidenceState) -> ConfidenceState:
    """Fresh statistics on the state's device."""
    return confidence_init(state.mean.device)


def confidence_state_dict(state: ConfidenceState) -> dict:
    """The checkpoint payload {mean, var, std}."""
    return {"mean": state.mean, "var": state.var, "std": state.std}


def confidence_load_state_dict(state: ConfidenceState, d: dict) -> ConfidenceState:
    dev = state.mean.device
    return state._replace(**{
        k: torch.as_tensor(d[k], dtype=torch.float32, device=dev).reshape(()) for k in ("mean", "var", "std")
    })
