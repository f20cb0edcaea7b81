"""Traversability MLP heads.

Port of wild_visual_navigation_tpu/models/simple_mlp.py: a Linear+ReLU
stack whose last layer emits [traversability (sigmoid) || feature
reconstruction] when `reconstruction=True`. Computes and returns float32.
Weights are drawn from a `torch.Generator` with the reference's
initialisers (truncated LeCun normal kernels, zero biases).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init of an (out, in, ...) weight."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # unit variance after truncation at 2 std
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def make_linear(d_in: int, d_out: int, generator: torch.Generator | None, device=None):
    lin = nn.Linear(d_in, d_out, device=device)
    with torch.no_grad():
        w = torch.empty((d_out, d_in))
        lin.weight.copy_(lecun_normal_(w, generator))
        lin.bias.zero_()
    return lin


class SimpleMLP(nn.Module):
    def __init__(self, input_size: int = 64, hidden_sizes: Sequence[int] = (255,), reconstruction: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_sizes = tuple(hidden_sizes)
        self.reconstruction = reconstruction
        sizes = [input_size, *self.hidden_sizes[:-1], self.output_features]
        self.layers = nn.ModuleList(
            make_linear(a, b, generator, device) for a, b in zip(sizes[:-1], sizes[1:])
        )

    @property
    def nr_sigmoid_layers(self) -> int:
        return self.hidden_sizes[-1]

    @property
    def output_features(self) -> int:
        return self.hidden_sizes[-1] + (self.input_size if self.reconstruction else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        for lin in self.layers[:-1]:
            h = torch.relu(lin(h))
        h = self.layers[-1](h)
        k = self.nr_sigmoid_layers
        return torch.cat([torch.sigmoid(h[..., :k]), h[..., k:]], dim=-1)


class DoubleMLP(nn.Module):
    """Separate traversability and reconstruction towers."""

    def __init__(self, input_size: int = 64, hidden_sizes: Sequence[int] = (255,), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_sizes = tuple(hidden_sizes)

        def tower(last):
            sizes = [input_size, *self.hidden_sizes[:-1], last]
            return nn.ModuleList(make_linear(a, b, generator, device) for a, b in zip(sizes[:-1], sizes[1:]))

        self.trav = tower(self.hidden_sizes[-1])
        self.reco = tower(input_size)

    @property
    def nr_sigmoid_layers(self) -> int:
        return self.hidden_sizes[-1]

    @property
    def output_features(self) -> int:
        return self.hidden_sizes[-1] + self.input_size

    @staticmethod
    def _run(layers, h):
        for lin in layers[:-1]:
            h = torch.relu(lin(h))
        return layers[-1](h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        return torch.cat([torch.sigmoid(self._run(self.trav, h)), self._run(self.reco, h)], dim=-1)
