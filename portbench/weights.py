"""Seeded weights, made on the device in a few large draws.

The backbone's state dict carries the torch-hub DINO / DINOv2 names that
the port loads (`blocks.N.attn.qkv.weight`, ...), from the sizes in a
configuration file alone; the head's those of a SimpleMLP
(`layers.N.weight`). Every matrix is a truncated LeCun normal (clamped
at two standard deviations), tokens 0.02-normal, biases 0, LayerNorms 1,
layer scales the configuration's value. Both the program and the plain
reference are given these same tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def vit_shapes(m: dict) -> dict:
    """Name -> shape of the ViT state dict for the configuration's `model`."""
    D, p, depth = m["embed_dim"], m["patch_size"], m["depth"]
    hidden = int(D * m["mlp_ratio"])
    shapes = {"patch_embed.proj.weight": (D, 3, p, p), "patch_embed.proj.bias": (D,), "cls_token": (1, 1, D),
              "pos_embed": (1, 1 + m["pos_grid_size"] ** 2, D)}
    if m.get("num_register_tokens", 0):
        shapes["register_tokens"] = (1, m["num_register_tokens"], D)
    for i in range(depth):
        b = f"blocks.{i}."
        shapes.update({b + "norm1.weight": (D,), b + "norm1.bias": (D,), b + "attn.qkv.weight": (3 * D, D),
                       b + "attn.qkv.bias": (3 * D,), b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
                       b + "norm2.weight": (D,), b + "norm2.bias": (D,), b + "mlp.fc1.weight": (hidden, D),
                       b + "mlp.fc1.bias": (hidden,), b + "mlp.fc2.weight": (D, hidden), b + "mlp.fc2.bias": (D,)})
        if m.get("layerscale") is not None:
            shapes.update({b + "ls1.gamma": (D,), b + "ls2.gamma": (D,)})
    shapes.update({"norm.weight": (D,), "norm.bias": (D,)})
    return shapes


def head_shapes(input_size: int, hidden_sizes) -> dict:
    sizes = [input_size, *hidden_sizes[:-1], hidden_sizes[-1] + input_size]
    out = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"layers.{i}.weight"] = (b, a)
        out[f"layers.{i}.bias"] = (b,)
    return out


def _fill(shapes: dict, generator: torch.Generator, device, layerscale=None) -> dict:
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


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(backbone state dict, head state dict), fp32, on `device`."""
    ss = np.random.SeedSequence([seed, 5]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(ss[0]))
    vit = _fill(vit_shapes(cfg["model"]), g, device, cfg.get("layerscale", cfg["model"].get("layerscale")))
    g.manual_seed(int(ss[1]))
    head = _fill(head_shapes(cfg["model"]["embed_dim"], cfg["head"]["hidden_sizes"]), g, device)
    return vit, head
