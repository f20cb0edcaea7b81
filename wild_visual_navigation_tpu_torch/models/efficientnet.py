"""EfficientNet feature-pyramid backbones.

Port of wild_visual_navigation_tpu/models/efficientnet.py: the MBConv
architecture with squeeze-excitation and swish, compound width / depth
scaling (b0, b4, b7) and frozen BatchNorm, emitting a 4-level pyramid at
strides 4 / 8 / 16 / 32 (stages 1, 2, 4 and 6) like the ResNet trunk.

The state dict follows the JAX module's own tree (`stem_conv`,
`stage{si}_{bi}.expand_conv`, `.dw_conv`, `.se.fc1`, `.project_bn`, ...),
not torchvision's `features[i]`; utils/params.py::efficientnet_state_from_jax
converts the JAX params. Types follow the JAX module as models/resnet.py
describes: convolutions (and the squeeze-excite biases) in `dtype`, the
BatchNorms, swish and the residual in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv, FrozenBatchNorm

# (expand_ratio, channels, layers, stride, kernel) — EfficientNet-B0 stages.
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

_SCALING = {  # width_mult, depth_mult
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b7": (2.0, 3.1),
}

_TAPS = {1: "layer1", 2: "layer2", 4: "layer3", 6: "layer4"}  # stage index -> pyramid level


def _round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    c = c * width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(r * depth_mult))


class SqueezeExcite(nn.Module):
    def __init__(self, in_channels: int, channels: int, dtype, device, generator):
        """The bottleneck is sized from the block input's channels
        (`in_channels // 4`), not from the expanded width."""
        super().__init__()
        se_c = max(1, in_channels // 4)
        self.fc1 = Conv(channels, se_c, 1, bias=True, dtype=dtype, device=device, generator=generator)
        self.fc2 = Conv(se_c, channels, 1, bias=True, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, expand_ratio: int, stride: int, kernel: int, dtype,
                 device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        c_mid = in_channels * expand_ratio
        self.expand_conv = self.expand_bn = None
        if expand_ratio != 1:
            self.expand_conv = Conv(in_channels, c_mid, 1, **kw)
            self.expand_bn = FrozenBatchNorm(c_mid, device=device)
        self.dw_conv = Conv(c_mid, c_mid, kernel, stride, kernel // 2, groups=c_mid, **kw)
        self.dw_bn = FrozenBatchNorm(c_mid, device=device)
        self.se = SqueezeExcite(in_channels, c_mid, **kw)
        self.project_conv = Conv(c_mid, out_channels, 1, **kw)
        self.project_bn = FrozenBatchNorm(out_channels, device=device)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        if self.expand_conv is not None:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.dw_bn(self.dw_conv(x)))
        x = self.se(x)
        x = self.project_bn(self.project_conv(x))
        return x + inp if self.residual else x


class EfficientNetPyramid(nn.Module):
    """EfficientNet trunk emitting the stride-4/8/16/32 pyramid."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0, dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        stem_c = _round_filters(32, width_mult)
        self.stem_conv = Conv(3, stem_c, 3, 2, 1, **kw)
        self.stem_bn = FrozenBatchNorm(stem_c, device=device)
        self.stages: list[list[str]] = []
        c_in = stem_c
        for si, (e, c, r, s, k) in enumerate(_B0_STAGES):
            c_out = _round_filters(c, width_mult)
            names = []
            for bi in range(_round_repeats(r, depth_mult)):
                self.add_module(f"stage{si}_{bi}", MBConv(c_in, c_out, e, s if bi == 0 else 1, k, **kw))
                names.append(f"stage{si}_{bi}")
                c_in = c_out
            self.stages.append(names)

    def forward(self, img: torch.Tensor) -> dict:
        """img: (B, 3, H, W) normalised -> {"layer1".."layer4"} fp32 NCHW."""
        x = F.silu(self.stem_bn(self.stem_conv(img.to(self.dtype))))
        out = {}
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if si in _TAPS:
                out[_TAPS[si]] = x.float()
        return out


def make_efficientnet(model_type: str = "efficientnet_b0", dtype=torch.bfloat16, device=None,
                      generator: torch.Generator | None = None) -> EfficientNetPyramid:
    if model_type not in _SCALING:
        raise ValueError(f"unknown efficientnet {model_type}; have {sorted(_SCALING)}")
    w, d = _SCALING[model_type]
    return EfficientNetPyramid(width_mult=w, depth_mult=d, dtype=dtype, device=device, generator=generator)


def efficientnet_pyramid_dim(model_type: str) -> int:
    w, _ = _SCALING[model_type]
    return sum(_round_filters(c, w) for c in (24, 40, 112, 320))
