"""Seeded weights, made on the device in one large draw a state dict.

A pipeline (`pipelines/<name>.py`) names its state dicts' tensors and
shapes from the sizes in a configuration file alone, and `_fill` draws
them: every matrix a truncated LeCun normal (clamped at two standard
deviations), tokens 0.02-normal, biases 0, LayerNorms 1, layer scales the
configuration's value. Both the program and the plain reference are given
these same tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _fill(shapes: dict, generator: torch.Generator, device, layerscale=None) -> dict:
    """Name -> shape to name -> tensor, every drawn tensor from one call of `generator`."""
    drawn = [n for n, s in shapes.items() if len(s) >= 2 and not n.endswith(".bias")]
    total = sum(int(np.prod(shapes[n])) for n in drawn)
    flat = torch.randn(total, generator=generator, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            n = int(np.prod(shape))
            w = flat[at:at + n].view(shape)
            at += n
            if name in ("cls_token", "pos_embed", "register_tokens"):
                out[name] = w * 0.02
            else:
                fan_in = int(np.prod(shape[1:]))
                out[name] = w * ((1.0 / fan_in) ** 0.5 / 0.87962566103423978)
        elif name.endswith(".gamma"):
            out[name] = torch.full(shape, float(layerscale), device=device)
        elif name.endswith(".weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
