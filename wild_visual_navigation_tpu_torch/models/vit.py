"""Vision Transformer (DINO / DINOv2) backbone.

Port of wild_visual_navigation_tpu/models/vit.py. Parameter names follow
the torch-hub checkpoints (`blocks.N.attn.qkv.weight`, ...), so
utils/params.py::vit_state_from_jax is the inverse of
tools/convert_dino_weights.py.

Numerics follow the reference's defaults: the linear layers and the
patch embedding compute in `dtype` (bf16 unless asked otherwise), with
their weights stored in that dtype as flax casts them at use; the
LayerNorms compute and return fp32. The patch embedding is a reshape
plus a matrix product, so no cuDNN convolution (and its default TF32)
is involved.

attention_impl:
  * "flash" — ops/flash_attention.py::flash_attention, kernel K1 on
    CUDA tensors at every shape (the plain version on CPU tensors);
  * "eager" — the plain einsum/softmax/einsum form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import flash_attention, xla_attention
from .simple_mlp import lecun_normal_


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    layerscale_init: Optional[float] = 1e-5  # None for DINO v1
    pos_grid_size: int = 37
    ln_eps: float = 1e-6


VIT_CONFIGS = {
    "dino_vit_small_8": ViTConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6, layerscale_init=None, pos_grid_size=28),
    "dino_vit_small_16": ViTConfig(patch_size=16, embed_dim=384, depth=12, num_heads=6, layerscale_init=None, pos_grid_size=14),
    "dino_vit_base_8": ViTConfig(patch_size=8, embed_dim=768, depth=12, num_heads=12, layerscale_init=None, pos_grid_size=28),
    "dino_vit_base_16": ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12, layerscale_init=None, pos_grid_size=14),
    "dinov2_vit_small_14": ViTConfig(patch_size=14, embed_dim=384, depth=12, num_heads=6),
    "dinov2_vit_base_14": ViTConfig(patch_size=14, embed_dim=768, depth=12, num_heads=12),
    "dinov2_vit_large_14": ViTConfig(patch_size=14, embed_dim=1024, depth=24, num_heads=16),
}

ATTENTION_IMPLS = ("flash", "eager")


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return nn.functional.linear(x.to(lin.weight.dtype), lin.weight, lin.bias)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str, dtype, device):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}")
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.attention_impl = attention_impl
        self.qkv = nn.Linear(D, 3 * D, device=device, dtype=dtype)
        self.proj = nn.Linear(D, D, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = _linear(x, self.qkv).reshape(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, H, N, Dh) views of the qkv product, no copies
        attend = flash_attention if self.attention_impl == "flash" else xla_attention
        out = attend(q, k, v, (D // H) ** -0.5)
        # K1 writes a (B, N, H, Dh) buffer, so on the card this is a view
        return _linear(out.transpose(1, 2).reshape(B, N, D), self.proj)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(nn.functional.gelu(_linear(x, self.fc1)), self.fc2)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str, dtype, device):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=cfg.ln_eps, device=device)
        self.attn = Attention(cfg, attention_impl, dtype, device)
        self.norm2 = nn.LayerNorm(D, eps=cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg, dtype, device)
        ls = cfg.layerscale_init is not None
        self.ls1 = LayerScale(D, cfg.layerscale_init, device) if ls else nn.Identity()
        self.ls2 = LayerScale(D, cfg.layerscale_init, device) if ls else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x.float())))
        return x + self.ls2(self.mlp(self.norm2(x.float())))


def _torch_bicubic_matrix(in_size: int, out_size: int, offset: float = 0.1) -> np.ndarray:
    """(out, in) matrix of torch's bicubic upsample (a = -0.75, given
    scale factor (out + offset) / in, clamped borders) as DINO's
    interpolate_pos_encoding calls it."""
    a = -0.75

    def cubic(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
        if x < 2.0:
            return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
        return 0.0

    scale = in_size / (out_size + offset)
    M = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        x = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(x))
        t = x - i0
        for off in (-1, 0, 1, 2):
            M[i, min(max(i0 + off, 0), in_size - 1)] += cubic(t - off)
    return M


def _interpolate_pos_embed(pos: torch.Tensor, grid0: int, hp: int, wp: int) -> torch.Tensor:
    """Bicubic resize of the (grid0², D) patch position table to (hp·wp, D)."""
    D = pos.shape[-1]
    if (hp, wp) == (grid0, grid0):
        return pos
    grid = pos.reshape(grid0, grid0, D).float()
    Mh = torch.as_tensor(_torch_bicubic_matrix(grid0, hp), device=pos.device)
    Mw = torch.as_tensor(_torch_bicubic_matrix(grid0, wp), device=pos.device)
    out = torch.einsum("oi,ijd->ojd", Mh, grid)
    out = torch.einsum("pj,ojd->opd", Mw, out)
    return out.reshape(hp * wp, D)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device):
        super().__init__()
        ps = cfg.patch_size
        self.patch_size = ps
        self.proj = nn.Conv2d(3, cfg.embed_dim, ps, ps, device=device, dtype=dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, hp·wp, D): the stride-ps convolution as a
        reshape and one matrix product."""
        B, C, H, W = img.shape
        ps = self.patch_size
        hp, wp = H // ps, W // ps
        x = img[:, :, : hp * ps, : wp * ps].to(self.proj.weight.dtype)
        x = x.reshape(B, C, hp, ps, wp, ps).permute(0, 2, 4, 1, 3, 5).reshape(B, hp * wp, C * ps * ps)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return nn.functional.linear(x, w, self.proj.bias)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str = "flash", dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None, state_dict: dict | None = None):
        """Weights from `state_dict` where one is given (the layers are
        then built on the meta device, so no initialiser runs), else the
        seeded draw of reset_parameters."""
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.embed_dim
        build = device if state_dict is None else "meta"
        self.patch_embed = PatchEmbed(cfg, dtype, build)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, device=build))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid_size**2, D, device=build))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, D, device=build))
        self.blocks = nn.ModuleList(Block(cfg, attention_impl, dtype, build) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.ln_eps, device=build)
        if state_dict is None:
            self.reset_parameters(generator)
        else:
            self.to_empty(device=device if device is not None else "cpu")
            self.load_state_dict(state_dict)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Seeded random init with the reference's initialisers: truncated
        LeCun normal kernels, zero biases, unit LayerNorms, 0.02 truncated
        normal tokens. Draws on the CPU, so a seed gives the same weights
        on every device."""
        for name, p in self.named_parameters():
            if name.endswith(".weight") and p.dim() >= 2:
                p.copy_(lecun_normal_(torch.empty(p.shape), generator))
            elif name in ("cls_token", "pos_embed", "register_tokens"):
                p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 0.02, -0.04, 0.04, generator=generator))
            elif name.endswith(".gamma"):
                p.fill_(self.cfg.layerscale_init)
            elif name.endswith(".weight"):  # LayerNorm scale
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, img: torch.Tensor) -> dict:
        """img: (B, 3, H, W) normalised -> {patch_tokens (B, hp·wp, D) fp32,
        cls_token (B, D) fp32, grid (hp, wp)}."""
        cfg = self.cfg
        B, _, H, W = img.shape
        hp, wp = H // cfg.patch_size, W // cfg.patch_size
        D = cfg.embed_dim
        x = self.patch_embed(img)
        pos_patch = _interpolate_pos_embed(self.pos_embed[0, 1:], cfg.pos_grid_size, hp, wp)
        x = x + pos_patch[None].to(self.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(self.dtype)
        tokens = [cls.expand(B, 1, D)]
        if cfg.num_register_tokens:
            tokens.append(self.register_tokens.to(self.dtype).expand(B, -1, D))
        x = torch.cat(tokens + [x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x.float())
        n_prefix = 1 + cfg.num_register_tokens
        return {"patch_tokens": x[:, n_prefix:], "cls_token": x[:, 0], "grid": (hp, wp)}


def dense_features(vit: VisionTransformer, img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, D, Hp, Wp) dense patch features."""
    out = vit(img)
    hp, wp = out["grid"]
    return out["patch_tokens"].reshape(img.shape[0], hp, wp, -1).permute(0, 3, 1, 2)


def make_vit(backbone: str = "dinov2", backbone_type: str = "vit_small", patch_size: int = 14,
             attention_impl: str = "flash", dtype: torch.dtype = torch.bfloat16, device=None,
             generator: torch.Generator | None = None, state_dict: dict | None = None) -> VisionTransformer:
    """Instantiate by the reference's (backbone, backbone_type, patch_size)."""
    key = f"{backbone}_vit_{backbone_type.replace('vit_', '')}_{patch_size}"
    if key not in VIT_CONFIGS:
        raise ValueError(f"Unknown ViT config {key}; have {sorted(VIT_CONFIGS)}")
    return VisionTransformer(VIT_CONFIGS[key], attention_impl=attention_impl, dtype=dtype, device=device,
                             generator=generator, state_dict=state_dict)
