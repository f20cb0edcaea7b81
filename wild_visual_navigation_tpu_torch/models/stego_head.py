"""STEGO segmentation head and per-image cosine k-means.

Port of wild_visual_navigation_tpu/models/stego_head.py: a projection head
distils ViT-B/8 features into a 90-d code (a linear and a two-layer
branch, summed), plus a cluster probe (learned class centres, cosine
similarity) and a linear probe over the code. `cosine_kmeans` clusters
each image's codes with cosine distance in fixed Lloyd steps.

The JAX package draws k-means' initial centres with
`jax.random.choice(key, ...)`, which a torch generator cannot reproduce,
so the port's `cosine_kmeans` takes the initial indices explicitly and
`kmeans_init_indices` draws them from a `torch.Generator`.
"""

from __future__ import annotations

import torch
from torch import nn

from .simple_mlp import make_linear


class StegoHead(nn.Module):
    """code = cluster1(f) + cluster2_fc2(relu(cluster2_fc1(f))), in fp32."""

    def __init__(self, in_dim: int = 768, code_dim: int = 90, n_classes: int = 27, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_dim, self.code_dim, self.n_classes = in_dim, code_dim, n_classes
        self.cluster1 = make_linear(in_dim, code_dim, generator, device)
        self.cluster2_fc1 = make_linear(in_dim, in_dim, generator, device)
        self.cluster2_fc2 = make_linear(in_dim, code_dim, generator, device)
        # flax's normal(0.02) initialiser
        probe = torch.randn((n_classes, code_dim), generator=generator) * 0.02
        self.cluster_probe = nn.Parameter(probe.to(device))
        self.linear_probe = make_linear(code_dim, n_classes, generator, device)

    def forward(self, feats: torch.Tensor) -> dict:
        """feats (B, N, in_dim) -> {"code": (B, N, code_dim), "cluster_logits":
        (B, N, n_classes) cosine similarities, "linear_logits": (B, N, n_classes)}."""
        h = feats.float()
        code = self.cluster1(h) + self.cluster2_fc2(torch.relu(self.cluster2_fc1(h)))
        code_n = code / (torch.linalg.vector_norm(code, dim=-1, keepdim=True) + 1e-8)
        probe = self.cluster_probe
        cent_n = probe / (torch.linalg.vector_norm(probe, dim=-1, keepdim=True) + 1e-8)
        return {"code": code, "cluster_logits": code_n @ cent_n.T, "linear_logits": self.linear_probe(code)}


def kmeans_init_indices(generator: torch.Generator, n_points: int, n_clusters: int) -> torch.Tensor:
    """k-means' initial centre indices: n_clusters distinct points, drawn
    with replacement only when there are fewer points than clusters (the
    surplus clusters then collapse and stay empty), as the JAX package
    draws them. A (n_clusters,) int64 CPU tensor."""
    if n_clusters > n_points:
        return torch.randint(0, n_points, (n_clusters,), generator=generator)
    return torch.randperm(n_points, generator=generator)[:n_clusters]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def cosine_kmeans(code: torch.Tensor, init_idx: torch.Tensor, iterations: int = 10):
    """Per-image k-means over codes with cosine distance.

    code (..., N, D); init_idx (..., S) or (S,) int indices of the initial
    centres. Each Lloyd step assigns every point its most similar centre
    (the first on ties) and moves each centre to the mean of its points;
    an empty cluster keeps its centre. Returns (labels (..., N) int32,
    centres (..., S, D))."""
    x = _unit(code.float())
    lead = x.shape[:-2]
    idx = init_idx.to(x.device).long().expand(*lead, init_idx.shape[-1])
    S = idx.shape[-1]
    centers = torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))
    ids = torch.arange(S, device=x.device)
    for _ in range(iterations):
        labels = torch.argmax(x @ _unit(centers).transpose(-1, -2), dim=-1)
        onehot = (labels[..., None] == ids).float()  # (..., N, S)
        sums = onehot.transpose(-1, -2) @ x
        counts = onehot.sum(-2)[..., None]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    labels = torch.argmax(x @ _unit(centers).transpose(-1, -2), dim=-1)
    return labels.to(torch.int32), centers
