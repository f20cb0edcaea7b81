"""ResNet feature-pyramid backbones.

Port of wild_visual_navigation_tpu/models/resnet.py: a frozen ResNet
trunk returning its four stage outputs as a feature pyramid
{"layer1": (B, C1, H/4, W/4), ..., "layer4": (B, C4, H/32, W/32)}, which
ops/segment_ops.py::segment_pyramid_pool pools per segment.

The state dict carries torchvision's ResNet names (`conv1`, `bn1`,
`layer1.0.conv1`, `layer1.0.downsample.0`, ...; BatchNorm's `weight`,
`bias`, `running_mean`, `running_var`), so a torchvision checkpoint loads
as it is; utils/params.py::resnet_state_from_jax converts the JAX params.

Types follow the JAX module op by op: each convolution casts its input to
`dtype` (bf16 by default) and returns `dtype`; FrozenBatchNorm holds fp32
statistics, so its output, the ReLUs, the residual adds and every block
output are fp32; each level leaves as fp32. The BatchNorm stays a separate
affine step after the convolution (folding it into the weights would move
the bf16 rounding).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .simple_mlp import lecun_normal_


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics only (inference mode), NCHW."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features, device=device))
        self.register_buffer("bias", torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # torchvision's BatchNorm2d also stores a step counter that inference ignores
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        return (x - self.running_mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


class Conv(nn.Module):
    """flax `nn.Conv(dtype=...)`: input, kernel (and bias) in `dtype`, output
    in `dtype`; symmetric explicit padding. The bias, when there is one, is
    added after the convolution in `dtype`, as flax adds it."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = False, dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        w = lecun_normal_(torch.empty(c_out, c_in // groups, kernel, kernel), generator)
        self.weight = nn.Parameter(w.to(device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c_out, device=device, dtype=dtype), requires_grad=False) if bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.weight.dtype), self.weight, None, self.stride, self.padding, 1, self.groups)
        return y if self.bias is None else y + self.bias[:, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = Conv(c_in, filters, 3, stride, 1, **kw)
        self.bn1 = FrozenBatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, 1, 1, **kw)
        self.bn2 = FrozenBatchNorm(filters, device=device)
        self.downsample = None
        if c_in != filters or stride != 1:
            self.downsample = nn.Sequential(Conv(c_in, filters, 1, stride, 0, **kw),
                                            FrozenBatchNorm(filters, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        out_f = filters * 4
        self.conv1 = Conv(c_in, filters, 1, 1, 0, **kw)
        self.bn1 = FrozenBatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, stride, 1, **kw)
        self.bn2 = FrozenBatchNorm(filters, device=device)
        self.conv3 = Conv(filters, out_f, 1, 1, 0, **kw)
        self.bn3 = FrozenBatchNorm(out_f, device=device)
        self.downsample = None
        if c_in != out_f or stride != 1:
            self.downsample = nn.Sequential(Conv(c_in, out_f, 1, stride, 0, **kw),
                                            FrozenBatchNorm(out_f, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetPyramid(nn.Module):
    """ResNet trunk returning the 4-stage feature pyramid."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
                 dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, 3, dtype=dtype, device=device, generator=generator)
        self.bn1 = FrozenBatchNorm(64, device=device)
        block = Bottleneck if bottleneck else BasicBlock
        c_in = 64
        for stage, (n_blocks, f) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(block(c_in, f, stride, dtype, device, generator))
                c_in = f * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, img: torch.Tensor) -> dict:
        """img: (B, 3, H, W) normalised -> dict of fp32 NCHW levels."""
        x = F.relu(self.bn1(self.conv1(img.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as flax's max_pool
        out = {}
        for stage in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
            out[f"layer{stage}"] = x.float()
        return out


_RESNETS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), bottleneck=False),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True),
    "resnet50_dino": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True),
}


def make_resnet(model_type: str = "resnet18", dtype=torch.bfloat16, device=None,
                generator: torch.Generator | None = None) -> ResNetPyramid:
    """Seeded LeCun-normal kernels (flax's Conv default) and identity
    BatchNorm, as the JAX module initialises."""
    if model_type not in _RESNETS:
        raise ValueError(f"unknown resnet {model_type}; have {sorted(_RESNETS)}")
    return ResNetPyramid(dtype=dtype, device=device, generator=generator, **_RESNETS[model_type])


def pyramid_feature_dim(model_type: str) -> int:
    """Total channel count of the concatenated 4-stage pyramid."""
    if model_type == "resnet18":
        return 64 + 128 + 256 + 512
    return 256 + 512 + 1024 + 2048
