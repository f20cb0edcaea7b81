"""Linear Kalman filter as a pure function over explicit state.

Port of wild_visual_navigation_tpu/utils/kalman_filter.py. The filter
matrices are tensors in a frozen dataclass, the state a NamedTuple; the
outlier rejection (none / hard / huber) is chosen by a Python string and
applied branch-free with `torch.where`. Used by the confidence
generator's `kalman_filter` method; the supervision generator runs the
same 1-d update on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch


class KalmanState(NamedTuple):
    x: torch.Tensor  # (D,) state estimate
    P: torch.Tensor  # (D, D) state covariance


@dataclass(frozen=True)
class KalmanFilterParams:
    """Filter configuration; matrices are (D, D), the control model (D, C)."""

    proc_model: torch.Tensor
    proc_cov: torch.Tensor
    meas_model: torch.Tensor
    meas_cov: torch.Tensor
    control_model: Optional[torch.Tensor] = None
    outlier_rejection: str = "none"
    outlier_delta: float = 1.0

    @staticmethod
    def make(
        dim_state: int = 1,
        proc_cov: float = 1.0,
        meas_cov: float = 1.0,
        outlier_rejection: str = "none",
        outlier_delta: float = 1.0,
        device=None,
    ) -> "KalmanFilterParams":
        eye = torch.eye(dim_state, dtype=torch.float32, device=device)
        return KalmanFilterParams(
            proc_model=eye,
            proc_cov=eye * proc_cov,
            meas_model=eye,
            meas_cov=eye * meas_cov,
            control_model=None,
            outlier_rejection=outlier_rejection,
            outlier_delta=outlier_delta,
        )


def kf_init(dim_state: int = 1, cov: float = 0.1, device=None) -> KalmanState:
    return KalmanState(
        x=torch.zeros((dim_state,), dtype=torch.float32, device=device),
        P=torch.eye(dim_state, dtype=torch.float32, device=device) * cov,
    )


def _outlier_weight(params: KalmanFilterParams, innovation: torch.Tensor) -> torch.Tensor:
    if params.outlier_rejection == "none":
        return torch.ones((), dtype=torch.float32, device=innovation.device)
    cov_inv = torch.linalg.inv(params.meas_cov)
    r = torch.sqrt(innovation @ cov_inv @ innovation)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    if params.outlier_rejection == "hard":
        return torch.where(r >= params.outlier_delta, zero, one)
    if params.outlier_rejection == "huber":
        return torch.where(torch.abs(r) <= params.outlier_delta, one, params.outlier_delta / torch.abs(r))
    raise ValueError(f"invalid outlier_rejection [{params.outlier_rejection}]")


def kf_step(
    params: KalmanFilterParams,
    state: KalmanState,
    meas,
    control: Optional[torch.Tensor] = None,
) -> KalmanState:
    """One predict + correct cycle."""
    A, Q = params.proc_model, params.proc_cov
    H, R = params.meas_model, params.meas_cov

    x = A @ state.x
    if control is not None and params.control_model is not None:
        x = x + params.control_model @ control
    P = A @ state.P @ A.T + Q

    meas = torch.atleast_1d(torch.as_tensor(meas, dtype=torch.float32, device=x.device))
    innovation = meas - H @ x
    w = _outlier_weight(params, innovation)
    S = H @ P @ H.T + R
    K = w * (P @ H.T @ torch.linalg.inv(S))
    x = x + K @ innovation
    P = (torch.eye(x.shape[0], dtype=P.dtype, device=P.device) - K @ H) @ P
    return KalmanState(x=x, P=P)


def kf_scan(params: KalmanFilterParams, state: KalmanState, measurements: torch.Tensor):
    """Filter a (T, D) measurement sequence; returns the final state and
    the (T, D) filtered trajectory."""
    xs = []
    for m in measurements:
        state = kf_step(params, state, m)
        xs.append(state.x)
    return state, torch.stack(xs)
