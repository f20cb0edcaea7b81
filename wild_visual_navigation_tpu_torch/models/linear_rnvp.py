"""RealNVP normalising flow for anomaly-detection mode.

Port of wild_visual_navigation_tpu/models/linear_rnvp.py: affine coupling
layers alternating with fixed random permutations (or mask flips), a
standard-normal prior. Forward returns {z, log_det, logprob}; `sample`
inverts the flow.

The permutations are drawn with numpy from `permutation_seed`, exactly as
the JAX package draws them, and kept as non-persistent buffers: the state
dict holds only the conditioner nets' weights. Weights are drawn from a
`torch.Generator` with the JAX package's initialisers (truncated LeCun
normal kernels, zero biases). Computes in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .simple_mlp import make_linear


class _CouplingNet(nn.Module):
    """The s/t conditioner: Linear(in, top[0]) + ReLU, then one Linear +
    ReLU per topology entry (so the first width appears twice, as in the
    reference), then Linear(top[-1], out)."""

    def __init__(self, in_size: int, topology: Sequence[int], out_size: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        sizes = [in_size, topology[0], *topology, out_size]
        self.layers = nn.ModuleList(make_linear(a, b, generator, device) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x)


class _CouplingLayer(nn.Module):
    """Affine coupling:

        forward:  x = m*u + (1-m) * (u * exp(s(m*u)) + t(m*u))
        backward: u = m*x + (1-m) * (x - t(m*x)) * exp(-s(m*x))

    with s squashed by tanh. single_function=True emits s and t from one
    net split in half; the default config uses two nets."""

    def __init__(self, mask: np.ndarray, topology: Sequence[int], single_function: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = len(mask)
        self.single_function = single_function
        self.register_buffer("mask", torch.as_tensor(np.asarray(mask, np.float32), device=device), persistent=False)
        if single_function:
            self.s_net = _CouplingNet(d, topology, 2 * d, device, generator)
        else:
            self.s_net = _CouplingNet(d, topology, d, device, generator)
            self.t_net = _CouplingNet(d, topology, d, device, generator)

    def _st(self, mx: torch.Tensor):
        if self.single_function:
            s, t = torch.chunk(self.s_net(mx), 2, dim=-1)
        else:
            s, t = self.s_net(mx), self.t_net(mx)
        return torch.tanh(s), t

    def forward(self, u: torch.Tensor):
        m = self.mask
        mu = u * m
        s, t = self._st(mu)
        x = mu + (1 - m) * (u * torch.exp(s) + t)
        return x, torch.sum((1 - m) * s, dim=-1)

    def backward(self, x: torch.Tensor):
        m = self.mask
        mx = x * m
        s, t = self._st(mx)
        u = mx + (1 - m) * (x - t) * torch.exp(-s)
        return u, torch.sum(-(1 - m) * s, dim=-1)


class LinearRnvp(nn.Module):
    """Defaults match cfg/experiment.py (input 384, topology [200], odds
    mask, permutations on, two conditioner nets). `batch_norm` is accepted
    and, as in the JAX package, does nothing."""

    def __init__(self, input_size: int = 384, coupling_topology: Sequence[int] = (200,), flow_n: int = 2,
                 use_permutation: bool = True, batch_norm: bool = False, mask_type: str = "odds",
                 single_function: bool = False, permutation_seed: int = 0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = self.input_size = input_size
        if mask_type == "odds":
            mask = (np.arange(d) % 2).astype(np.float32)
        elif mask_type == "half":
            mask = np.zeros(d, np.float32)
            mask[: d // 2] = 1
        else:
            raise ValueError(mask_type)
        masks = []
        for _ in range(flow_n):
            masks.append(mask)
            if not use_permutation:
                mask = 1 - mask  # without permutations the coupling masks alternate
        self.layers = nn.ModuleList(_CouplingLayer(m, tuple(coupling_topology), single_function, device, generator)
                                    for m in masks)
        self.use_permutation = use_permutation
        if use_permutation:
            rng = np.random.RandomState(permutation_seed)
            perms = np.stack([rng.permutation(d) for _ in range(flow_n)])  # (flow_n, d), layer by layer
            self.register_buffer("perms", torch.as_tensor(perms, device=device), persistent=False)
            self.register_buffer("inv_perms", torch.as_tensor(np.argsort(perms, axis=1), device=device),
                                 persistent=False)

    def _flow_forward(self, x: torch.Tensor):
        log_det = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            x, ld = layer(x)
            log_det = log_det + ld
            if self.use_permutation:
                x = x[..., self.perms[i]]
        return x, log_det

    def _flow_backward(self, u: torch.Tensor):
        log_det = torch.zeros(u.shape[:-1], dtype=torch.float32, device=u.device)
        for i in reversed(range(len(self.layers))):
            if self.use_permutation:
                u = u[..., self.inv_perms[i]]
            u, ld = self.layers[i].backward(u)
            log_det = log_det + ld
        return u, log_det

    @staticmethod
    def logprob(z: torch.Tensor) -> torch.Tensor:
        """Per-dimension standard-normal log density."""
        return -0.5 * (z**2) - 0.5 * math.log(2 * math.pi)

    def forward(self, x: torch.Tensor) -> dict:
        z, log_det = self._flow_forward(x.float())
        return {"z": z, "log_det": log_det, "logprob": self.logprob(z)}

    def sample(self, generator: torch.Generator, samples: int = 1, return_logdet: bool = False):
        """Draw `samples` points through the inverse flow; the normal draw
        comes from `generator` (on the module's device)."""
        dev = self.layers[0].mask.device
        u = torch.randn((samples, self.input_size), generator=generator, device=dev)
        z, d = self._flow_backward(u)
        if return_logdet:
            return z, torch.sum(self.logprob(u), dim=-1) + d
        return z
