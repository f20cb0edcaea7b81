"""Fixed-shape training-batch containers.

Port of wild_visual_navigation_tpu/utils/data.py. Every mission node
carries a static number of segment slots S with a validity mask, so a
batch is a plain stack. `TravBatch` is the flattened (B*S, ...) view the
loss takes: `sample_valid` marks real segments, `y_valid` supervised ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


class NodeData(NamedTuple):
    """One mission node's training payload, padded to S segment slots."""

    x: torch.Tensor  # (S, D) per-segment features
    y: torch.Tensor  # (S,) supervision signal in [0, 1]
    y_valid: torch.Tensor  # (S,) bool: segment has supervision
    sample_valid: torch.Tensor  # (S,) bool: segment slot is real
    edges: Optional[torch.Tensor] = None  # (2, E) int32
    edge_valid: Optional[torch.Tensor] = None  # (E,) bool


class TravBatch(NamedTuple):
    """Flattened batch of node data, N = B*S samples. `edges` /
    `edge_valid` carry per-node adjacency for graph heads (None for row
    heads)."""

    x: torch.Tensor  # (N, D)
    y: torch.Tensor  # (N,)
    y_valid: torch.Tensor  # (N,) bool
    sample_valid: torch.Tensor  # (N,) bool
    edges: Optional[torch.Tensor] = None  # (B, 2, E) int32
    edge_valid: Optional[torch.Tensor] = None  # (B, E) bool

    @property
    def num_samples(self) -> torch.Tensor:
        return torch.sum(self.sample_valid)


def batch_from_nodes(nodes: Sequence[NodeData]) -> TravBatch:
    """Concatenate node payloads into one flat batch."""
    return TravBatch(
        x=torch.cat([n.x for n in nodes], dim=0),
        y=torch.cat([n.y for n in nodes], dim=0),
        y_valid=torch.cat([n.y_valid for n in nodes], dim=0),
        sample_valid=torch.cat([n.sample_valid for n in nodes], dim=0),
    )


def batch_from_arrays(x: torch.Tensor, y: torch.Tensor, y_valid: torch.Tensor, sample_valid: torch.Tensor) -> TravBatch:
    """Flatten (B, S, ...) stacked arrays into a TravBatch."""
    return TravBatch(
        x=x.reshape(-1, x.shape[-1]),
        y=y.reshape(-1),
        y_valid=y_valid.reshape(-1),
        sample_valid=sample_valid.reshape(-1),
    )
