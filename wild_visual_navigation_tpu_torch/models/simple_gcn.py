"""Graph-convolution traversability head over the segment adjacency.

Port of wild_visual_navigation_tpu/models/simple_gcn.py: fixed-size
padded edge lists with validity masks, the symmetric-normalised GCNConv
rule with self loops, scatter-adds as `index_add_`. An invalid edge
points at node 0 with weight 0, so it adds nothing; with no edges the
head degrades to its self loop, a per-row head.

A batch of graphs is one graph: node b's segments are rows b·S to
b·S + S - 1, and its edges are offset by b·S (`batch_graph`), so one
`index_add_` serves the whole batch. On CUDA `index_add_` adds with
atomics in no fixed order, so sums may differ in their last bits from
run to run.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .simple_mlp import make_linear


def gcn_aggregate(x: torch.Tensor, edges: torch.Tensor, edge_valid: torch.Tensor) -> torch.Tensor:
    """Symmetric-normalised neighbourhood aggregation.

    x (S, D) node features; edges (2, E) ids, undirected with one
    direction per pair (both directions are added here); edge_valid (E,)
    bool. Self loops are always included."""
    S = x.shape[0]
    src = torch.where(edge_valid, edges[0], 0).long()
    dst = torch.where(edge_valid, edges[1], 0).long()
    w = edge_valid.to(x.dtype)

    deg = torch.ones((S,), dtype=x.dtype, device=x.device)  # self loops
    deg = deg.index_add(0, dst, w).index_add(0, src, w)
    norm = torch.rsqrt(deg)

    coef = (norm[src] * norm[dst] * w)[:, None]
    out = x * (norm * norm)[:, None]  # self loop
    return out.index_add(0, dst, x[src] * coef).index_add(0, src, x[dst] * coef)


def batch_graph(edges: torch.Tensor, edge_valid: torch.Tensor, num_segments: int):
    """(B, 2, E) per-node edges and (B, E) validity -> one (2, B·E) edge
    list over B·num_segments rows and its (B·E,) validity."""
    B = edges.shape[0]
    off = (torch.arange(B, device=edges.device, dtype=edges.dtype) * num_segments)[:, None, None]
    return (edges + off).permute(1, 0, 2).reshape(2, -1), edge_valid.reshape(-1)


class SimpleGCN(nn.Module):
    """Linear -> GCN aggregation -> ReLU for each hidden width, then a
    per-node Linear head with SimpleMLP's [sigmoid(trav) || reconstruction]
    output. Layers are `layers.i`, as SimpleMLP's, so the JAX Dense_i
    params carry over by the same bridge. Computes and returns float32."""

    def __init__(self, input_size: int = 384, hidden_sizes: Sequence[int] = (256, 128, 1), reconstruction: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_sizes = tuple(hidden_sizes)
        self.reconstruction = reconstruction
        last = self.hidden_sizes[-1] + (input_size if reconstruction else 0)
        sizes = [input_size, *self.hidden_sizes[:-1], last]
        self.layers = nn.ModuleList(make_linear(a, b, generator, device) for a, b in zip(sizes[:-1], sizes[1:]))

    @property
    def nr_sigmoid_layers(self) -> int:
        return self.hidden_sizes[-1]

    def forward(self, x: torch.Tensor, edges: torch.Tensor, edge_valid: torch.Tensor) -> torch.Tensor:
        h = x.float()
        for lin in self.layers[:-1]:
            h = torch.relu(gcn_aggregate(lin(h), edges, edge_valid))
        h = self.layers[-1](h)
        k = self.nr_sigmoid_layers
        return torch.cat([torch.sigmoid(h[..., :k]), h[..., k:]], dim=-1)
