"""Confidence from reconstruction losses: state and inference.

Port of the inference half of
wild_visual_navigation_tpu/utils/confidence_generator.py. The state is an
explicit NamedTuple of tensors, as in the reference; `confidence_update`
and the Kalman-filter method come with the learning loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

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


def confidence_state_dict(state: ConfidenceState) -> dict:
    """The checkpoint payload {mean, var, std}."""
    return {"mean": state.mean, "var": state.var, "std": state.std}


def confidence_load_state_dict(state: ConfidenceState, d: dict) -> ConfidenceState:
    dev = state.mean.device
    return state._replace(**{
        k: torch.as_tensor(d[k], dtype=torch.float32, device=dev).reshape(()) for k in ("mean", "var", "std")
    })
