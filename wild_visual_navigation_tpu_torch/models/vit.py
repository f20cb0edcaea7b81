"""Vision Transformer (DINO / DINOv2) backbone.

Port of wild_visual_navigation_tpu/models/vit.py. Parameter names follow
the torch-hub checkpoints (`blocks.N.attn.qkv.weight`, ...), so
utils/params.py::vit_state_from_jax is the inverse of
tools/convert_dino_weights.py.

Numerics follow the reference's defaults: the linear layers and the
patch embedding compute in `dtype` (bf16 unless asked otherwise), with
their weights stored in that dtype as flax casts them at use; the
LayerNorms compute in fp32 and return `ln_dtype` (fp32 unless asked
otherwise), as flax's LayerNorm(dtype=ln_dtype) computes its statistics
and affine in fp32 and casts the result; the final norm returns fp32
whatever `ln_dtype` says, as the reference's does. A bf16 `ln_dtype`
changes nothing a bf16 linear layer sees (it casts its input to bf16
anyway); it changes what a quantised layer sees, whose activation
abs-max is then taken over bf16 values. The patch embedding is a reshape
plus a matrix product, so no cuDNN convolution (and its default TF32)
is involved.

attention_impl, the reference's names with the reference's meaning:
  * "flash" — ops/flash_attention.py::flash_attention, kernel K1 on CUDA
    tensors at every shape (the plain version on CPU tensors); under
    torch.export the operator `wvn::flash_attention`. The default here,
    where the reference's make_vit defaults to "xla": the card's path
    runs K1;
  * "flash:<block_q>:<block_k>" — K1 with that tile (ops/flash_attention.py::
    TILES); a tile K1 does not hold at the head dim raises when the ViT is
    built;
  * "flash_interpret" — K1's plain version on any device, the explicit
    request for the kernel's semantics without the kernel (the
    reference's Pallas interpret mode);
  * "xla" — the plain einsum/softmax/einsum form; "eager" is its older
    name here;
  * "xla_bf16" — the reference's bf16-score form
    (ops/flash_attention.py::xla_attention_bf16);
  * "xla_int8" — both attention products in int8
    (models/quant.py::attention_scores_int8);
  * "auto" — the reference's rule by shape: "flash" when B·H >= 48 and
    N >= 512, else "xla_bf16", with one line on stderr per resolved
    shape. It resolves on the global (B, H), as the reference resolves
    inside jit on global shapes: the model's unsharded head count under
    `shard_heads_`, and the batch times the dp group's size when frames
    are split over one (`share_scales_` names it).

quant (the JAX package's W8A8 backbone, models/quant.py): "int8" puts
qkv, proj, fc1 and fc2 on int8 products with a per-call activation scale,
"int8_static" with a calibrated one (`calibrate_int8_static`); the patch
embedding and the LayerNorms stay as they are. The parameters keep the fp
ViT's names and shapes, so fp checkpoints load as they are, but the
quantised layers hold their weights in fp32, as the JAX package quantises
its fp32 kernels. The backbone is frozen, so each layer quantises its
weight once, into non-persistent buffers that a load_state_dict refreshes;
a static layer's activation abs-max is a persistent buffer `amax`, zero
until calibrated (a checkpoint without it loads with zeros, as JAX seeds
the missing "quant_cal" collection).

Tensor parallelism (`shard_heads_`, forward only): each rank of a tp
process group keeps the qkv rows and proj columns of its own heads and its
rows of fc1 and columns of fc2, as plain tensors. Attention (K1 on the
rank's heads) needs no collective; one all_reduce follows proj and one
follows fc2, in fp32, and their biases are added once, after the sum.

A quantised ViT under a mesh computes what JAX's sharded program computes
on the global tensors (`share_scales_` names the process groups):
  * qkv and fc1 (column-parallel) keep their rows, whose per-output-channel
    weight scales depend on their own row alone; proj and fc2
    (row-parallel) keep the full weight's scales, and sum their int32
    accumulators over tp (exact) before one dequantisation and the bias;
  * "int8" takes each per-tensor activation abs-max with a MAX all_reduce:
    over dp for qkv and fc1 (their input is replicated over tp, its frames
    split over dp), over the whole mesh for proj and fc2 and for
    "xla_int8"'s q, k and v (frames over dp, features or heads over tp);
  * "int8_static" reduces its recorded amax the same way once, when a
    calibration ends, and needs no collective per call.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.flash_attention import flash_attention, kernel_tile, xla_attention, xla_attention_bf16
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD
from .quant import attention_scores_int8, int8_matmul_scaled, max_over, quantize_symmetric, quantize_with_scale
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

ATTENTION_IMPLS = ("flash", "flash_interpret", "xla", "eager", "xla_bf16", "xla_int8", "auto")  # and "flash:<bq>:<bk>"
QUANT_MODES = (None, "int8", "int8_static")
# The (B, H, N) shapes "auto" has resolved, each logged once on stderr: the
# choice changes the output's rounding, so it should be visible.
_AUTO_RESOLVED_LOGGED: set = set()


def attention_blocks(attention_impl: str) -> tuple[int, int] | None:
    """K1's (block_q, block_k) for "flash:<bq>:<bk>", parsed as the
    reference parses it; (0, 0) for "flash"; None for the other names.
    Raises for a name the reference does not take."""
    if attention_impl.startswith("flash:"):
        parts = attention_impl.split(":")
        if len(parts) != 3 or not all(p.isdigit() for p in parts[1:]):
            raise ValueError(f"attention_impl {attention_impl!r}: expected 'flash:<block_q>:<block_k>'")
        return int(parts[1]), int(parts[2])
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS} or 'flash:<block_q>:<block_k>', got "
                         f"{attention_impl!r}")
    return (0, 0) if attention_impl == "flash" else None


def resolve_auto(B: int, H: int, N: int) -> str:
    """The reference's "auto" rule on global shapes: "flash" when B·H >= 48
    and N >= 512, else "xla_bf16"; logs each new (B, H, N) on stderr."""
    impl = "flash" if (B * H >= 48 and N >= 512) else "xla_bf16"
    if (B, H, N) not in _AUTO_RESOLVED_LOGGED:
        _AUTO_RESOLVED_LOGGED.add((B, H, N))
        print(f"[vit] attention auto(B={B}, heads={H}, S={N}) -> {impl}", file=sys.stderr)
    return impl


class QuantLinear(nn.Module):
    """nn.Linear's parameters (fp32) with the product in int8: the weight
    per output channel, the activation per call, as it arrives (fp32 from
    a LayerNorm, the compute type after attention or GELU); the output in
    `dtype`. The counterpart of JAX's QuantDense.

    Under a mesh: `scale_group` is the process group the activation
    abs-max is MAX-reduced over; `tp_group` marks a row-parallel slice
    (models/vit.py::shard_heads_), whose int32 accumulators are summed
    over it and whose weight scales are the full weight's."""

    def __init__(self, in_features: int, out_features: int, dtype, device):
        super().__init__()
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8, device=device),
                             persistent=False)  # (out, in): the (in, out) operand column-major, as cuBLASLt takes it
        self.register_buffer("weight_scale", torch.ones(1, out_features, device=device), persistent=False)
        self.scale_group = None
        self.tp_group = None
        self.register_load_state_dict_post_hook(lambda module, _: module.refresh_())

    @torch.no_grad()
    def refresh_(self) -> None:
        """Quantise the weight again (after its values changed). A
        row-parallel slice keeps the full weight's per-channel scales: the
        slice's own maxima would be other scales."""
        if self.weight.device.type == "meta":
            return
        w = self.weight.float().t()  # the flax (in, out) kernel, quantised per output channel
        if self.tp_group is None:
            wq, sw = quantize_symmetric(w, dim=0)
        else:
            wq, sw = quantize_with_scale(w, self.weight_scale), self.weight_scale
        self.weight_q, self.weight_scale = wq.t().contiguous(), sw

    def _product(self, xq: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
        return int8_matmul_scaled(xq, sx, self.weight_q.t(), self.weight_scale, self.bias,
                                  self.tp_group).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._product(*quantize_symmetric(x, group=self.scale_group))


class StaticQuantLinear(QuantLinear):
    """QuantLinear with a calibrated activation scale, max(amax / 127,
    1e-12), computed once per calibration. While `calibrating` it records
    amax = max(amax, max |x|) and computes as QuantLinear does. The
    counterpart of JAX's StaticQuantDense."""

    def __init__(self, in_features: int, out_features: int, dtype, device):
        super().__init__(in_features, out_features, dtype, device)
        self.calibrating = False
        self.register_buffer("amax", torch.zeros((), device=device))
        self.register_buffer("x_scale", torch.full((), 1e-12, device=device), persistent=False)
        self._register_load_state_dict_pre_hook(self._default_amax)

    @staticmethod
    def _default_amax(state_dict, prefix, *args) -> None:
        state_dict.setdefault(prefix + "amax", torch.zeros(()))

    @torch.no_grad()
    def refresh_(self) -> None:
        super().refresh_()
        if self.amax.device.type != "meta":
            self.x_scale = torch.clamp(self.amax / torch.full_like(self.amax, 127.0), min=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            self.amax.copy_(torch.maximum(self.amax, x.abs().amax().float()))
            return super().forward(x)
        return self._product(quantize_with_scale(x, self.x_scale), self.x_scale)


def _make_linear(quant: Optional[str], in_features: int, out_features: int, dtype, device) -> nn.Module:
    if quant == "int8":
        return QuantLinear(in_features, out_features, dtype, device)
    if quant == "int8_static":
        return StaticQuantLinear(in_features, out_features, dtype, device)
    return nn.Linear(in_features, out_features, device=device, dtype=dtype)


def _linear(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    if isinstance(lin, QuantLinear):
        return lin(x)
    return nn.functional.linear(x.to(lin.weight.dtype), lin.weight, lin.bias)


def _row_parallel(x: torch.Tensor, lin: nn.Linear, group) -> torch.Tensor:
    """`lin` on x, where each rank of `group` holds its columns of the
    weight and x its slice of the input features: the partial products
    summed in fp32 over the group, then the bias, once. A quantised layer
    sums its int32 accumulators itself."""
    if group is None or isinstance(lin, QuantLinear):
        return _linear(x, lin)
    y = nn.functional.linear(x.to(lin.weight.dtype), lin.weight).float()
    dist.all_reduce(y, group=group)
    return (y + lin.bias.float()).to(lin.weight.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str, dtype, device, quant: Optional[str] = None):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads  # this rank's heads under tensor parallelism
        self.global_heads = cfg.num_heads  # the model's, which "auto" resolves on
        self.head_dim = D // cfg.num_heads
        self.attention_impl = attention_impl
        self.blocks = attention_blocks(attention_impl)
        if self.blocks is not None and dtype in (torch.float32, torch.bfloat16):
            kernel_tile(self.head_dim, dtype, *self.blocks)  # raises for a tile K1 does not hold
        self.tp_group = None
        self.scale_group = None  # "xla_int8": the group its q, k, v abs-maxes are MAX-reduced over
        self.batch_group = None  # the group this rank's frames are one share of ("auto" counts the whole batch)
        self.qkv = _make_linear(quant, D, 3 * D, dtype, device)
        self.proj = _make_linear(quant, D, D, dtype, device)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
        impl, blocks = self.attention_impl, self.blocks
        if impl == "auto":
            B = q.shape[0] * (dist.get_world_size(self.batch_group) if self.batch_group is not None else 1)
            impl = resolve_auto(B, self.global_heads, q.shape[2])
            blocks = (0, 0) if impl == "flash" else None
        if blocks == (0, 0):
            return flash_attention(q, k, v, scale)
        if blocks is not None:
            return flash_attention(q, k, v, scale, *blocks)
        if impl == "flash_interpret":
            return xla_attention(q, k, v, scale)  # K1's plain version, on any device
        if impl == "xla_bf16":
            return xla_attention_bf16(q, k, v, scale)
        if impl == "xla_int8":
            return attention_scores_int8(q, k, v, scale, group=self.scale_group)
        return xla_attention(q, k, v, scale)  # "xla", "eager"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        qkv = _linear(x, self.qkv).reshape(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, H, N, Dh) views of the qkv product, no copies
        out = self._attend(q, k, v, Dh**-0.5)
        # K1 writes a (B, N, H, Dh) buffer, so on the card this is a view
        return _row_parallel(out.transpose(1, 2).reshape(B, N, H * Dh), self.proj, self.tp_group)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device, quant: Optional[str] = None):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = _make_linear(quant, cfg.embed_dim, hidden, dtype, device)
        self.fc2 = _make_linear(quant, hidden, cfg.embed_dim, dtype, device)
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _row_parallel(nn.functional.gelu(_linear(x, self.fc1)), self.fc2, self.tp_group)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str, dtype, device, quant: Optional[str] = None,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        D = cfg.embed_dim
        self.ln_dtype = ln_dtype
        self.norm1 = nn.LayerNorm(D, eps=cfg.ln_eps, device=device)
        self.attn = Attention(cfg, attention_impl, dtype, device, quant)
        self.norm2 = nn.LayerNorm(D, eps=cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg, dtype, device, quant)
        ls = cfg.layerscale_init is not None
        self.ls1 = LayerScale(D, cfg.layerscale_init, device) if ls else nn.Identity()
        self.ls2 = LayerScale(D, cfg.layerscale_init, device) if ls else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x.float()).to(self.ln_dtype)))
        return x + self.ls2(self.mlp(self.norm2(x.float()).to(self.ln_dtype)))


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


_BICUBIC_MATRICES: dict = {}  # (device, in_size, out_size) -> (out, in) fp32


def bicubic_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """`_torch_bicubic_matrix` as an fp32 tensor on `device`, built once per
    (device, in_size, out_size) and kept there: on the card a host-to-device
    copy waits for the stream, and a CUDA graph's capture takes none."""
    key = (torch.device(device), in_size, out_size)
    hit = _BICUBIC_MATRICES.get(key)
    if hit is None:
        hit = _BICUBIC_MATRICES.setdefault(key, torch.as_tensor(_torch_bicubic_matrix(in_size, out_size),
                                                                device=key[0]))
    return hit


def _interpolate_pos_embed(pos: torch.Tensor, grid0: int, hp: int, wp: int) -> torch.Tensor:
    """Bicubic resize of the (grid0², D) patch position table to (hp·wp, D)."""
    D = pos.shape[-1]
    if (hp, wp) == (grid0, grid0):
        return pos
    grid = pos.reshape(grid0, grid0, D).float()
    Mh = bicubic_matrix(grid0, hp, pos.device)
    Mw = bicubic_matrix(grid0, wp, pos.device)
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


def _bump_after_load(vit, incompatible_keys) -> None:
    vit.bump_generation()


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str = "flash", dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None, state_dict: dict | None = None,
                 quant: Optional[str] = None, ln_dtype: torch.dtype = torch.float32):
        """Weights from `state_dict` where one is given (the layers are
        then built on the meta device, so no initialiser runs), else the
        seeded draw of reset_parameters. `quant`: one of QUANT_MODES;
        `ln_dtype`: the blocks' LayerNorm output type.

        `generation` counts the changes that may put new tensors in the
        layers (a reset or a load, which requantise a quantised layer's
        weight; a calibration; a tensor-parallel cut), so that a CUDA graph
        of the forward, which holds the tensors it was captured with, can
        tell it is stale."""
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        self.generation = 0
        self.register_load_state_dict_post_hook(_bump_after_load)
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        self.ln_dtype = ln_dtype
        D = cfg.embed_dim
        build = device if state_dict is None else "meta"
        self.patch_embed = PatchEmbed(cfg, dtype, build)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, device=build))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid_size**2, D, device=build))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, D, device=build))
        self.blocks = nn.ModuleList(Block(cfg, attention_impl, dtype, build, quant, ln_dtype) for _ in range(cfg.depth))
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
        for m in self.modules():
            if isinstance(m, QuantLinear):
                m.refresh_()
        self.bump_generation()

    def bump_generation(self) -> None:
        self.generation += 1

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


@torch.no_grad()
def calibrate_int8_static(vit: VisionTransformer, sample_batches) -> VisionTransformer:
    """Record each StaticQuantLinear's activation abs-max over the (B, 3, H,
    W) normalised batches, in place (running max over the batches, on top
    of what the layers held), and refresh their scales. The counterpart of
    JAX's calibrate_int8_static, which returns the updated variables. Under
    a mesh (`share_scales_`) every rank calls it on its own batches, and
    each amax is then the maximum over the ranks that split its input."""
    layers = [m for m in vit.modules() if isinstance(m, StaticQuantLinear)]
    for m in layers:
        m.calibrating = True
    try:
        for imgs in sample_batches:
            vit(imgs)
        for m in layers:  # under a mesh: the global abs-max, as JAX records it
            m.amax.copy_(max_over(m.amax.clone(), m.scale_group))
    finally:
        for m in layers:
            m.calibrating = False
            m.refresh_()
        if isinstance(vit, VisionTransformer):  # it also takes a lone layer
            vit.bump_generation()
    return vit


def _keep(lin: nn.Linear, rows=None, cols=None, group=None) -> None:
    """Replace lin's weight (and bias, for a row cut) by the kept slices. A
    quantised layer quantises its slice again; a cut of the input features
    (`cols`, a row-parallel layer with `group` its tp group) keeps the full
    weight's scales."""
    w, b = lin.weight.detach(), lin.bias.detach()
    if rows is not None:
        w, b = w[rows], b[rows]
    if cols is not None:
        w = w[:, cols]
    lin.weight = nn.Parameter(w.contiguous(), requires_grad=False)
    lin.bias = nn.Parameter(b.contiguous(), requires_grad=False)
    lin.out_features, lin.in_features = w.shape
    if isinstance(lin, QuantLinear):
        lin.tp_group = group
        lin.refresh_()


@torch.no_grad()
def shard_heads_(vit: VisionTransformer, group, rank: int, tp: int, spec: dict) -> VisionTransformer:
    """Tensor-parallel ViT, in place: rank `rank` of the tp process group
    `group` keeps, in every block whose layers `spec` shards
    (parallel/mesh.py::vit_param_spec), the qkv rows of heads
    [rank·H/tp, (rank+1)·H/tp) as [q_h, k_h, v_h], the matching proj
    columns, and its 1/tp of fc1's rows and fc2's columns. Every rank must
    start from the same full weights. Forward only. A quantised ViT keeps
    the full weights' scales in proj and fc2 and sums their int32
    accumulators (see the module's docstring); `share_scales_` then names
    the groups its activation scales are reduced over."""
    from torch.distributed.tensor import Shard

    for i, blk in enumerate(vit.blocks):
        attn, mlp = blk.attn, blk.mlp
        if isinstance(spec.get(f"blocks.{i}.attn.qkv.weight"), Shard):
            H, Dh = attn.num_heads, attn.head_dim
            hl = H // tp
            heads = torch.arange(rank * hl, (rank + 1) * hl, device=attn.qkv.weight.device)
            # qkv rows are (3, H, Dh): this rank's heads in each of q, k and v
            rows = (torch.arange(3, device=heads.device)[:, None, None] * H * Dh + heads[None, :, None] * Dh
                    + torch.arange(Dh, device=heads.device)[None, None, :]).reshape(-1)
            _keep(attn.qkv, rows=rows)
            _keep(attn.proj, cols=(heads[:, None] * Dh + torch.arange(Dh, device=heads.device)).reshape(-1),
                  group=group)
            attn.num_heads, attn.tp_group = hl, group
        if isinstance(spec.get(f"blocks.{i}.mlp.fc1.weight"), Shard):
            n = mlp.fc1.out_features // tp
            cut = slice(rank * n, (rank + 1) * n)
            _keep(mlp.fc1, rows=cut)
            _keep(mlp.fc2, cols=cut, group=group)
            mlp.tp_group = group
    vit.bump_generation()
    return vit


def share_scales_(vit: VisionTransformer, dp_group, mesh_group) -> VisionTransformer:
    """The process groups a ViT under a ("dp", "tp") mesh reduces its
    per-tensor activation scales over, in place: `dp_group` for the
    column-parallel qkv and fc1, whose input every tp rank holds whole;
    `mesh_group` (dp and tp) for a row-parallel proj or fc2 and for
    "xla_int8"'s q, k and v, whose features or heads tp splits as well
    (`dp_group` where tp left the block's layer whole). None: no
    reduction. `dp_group` is also the group whose frames "auto" attention
    counts as one batch. Call it after `shard_heads_`, on every rank."""
    for blk in vit.blocks:
        attn, mlp = blk.attn, blk.mlp
        attn_rows = mesh_group if attn.tp_group is not None else dp_group
        attn.scale_group = attn_rows
        attn.batch_group = dp_group
        for lin, group in ((attn.qkv, dp_group), (attn.proj, attn_rows), (mlp.fc1, dp_group),
                           (mlp.fc2, mesh_group if mlp.tp_group is not None else dp_group)):
            if isinstance(lin, QuantLinear):
                lin.scale_group = group
    vit.bump_generation()
    return vit


def fold_imagenet_normalize(state_dict: dict) -> dict:
    """The ViT's state dict with the ImageNet normalisation folded into the
    patch embedding, as the JAX package's function of the same name folds
    it: (x - mean) / std followed by the linear patch embedding equals the
    embedding with its weight divided by std per input channel and its bias
    shifted by the new weight's sum against mean. A ViT carrying the result
    takes raw [0, 1] images. A new dict; the other entries are the same
    tensors."""
    w, b = state_dict["patch_embed.proj.weight"], state_dict["patch_embed.proj.bias"]  # (D, 3, ps, ps), (D,)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=w.device).to(w.dtype).reshape(1, 3, 1, 1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=w.device).to(w.dtype).reshape(1, 3, 1, 1)
    new_w = w / std
    return {**state_dict, "patch_embed.proj.weight": new_w,
            "patch_embed.proj.bias": b - torch.sum(new_w * mean, dim=(1, 2, 3))}


def dense_features(vit: VisionTransformer, img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, D, Hp, Wp) dense patch features."""
    out = vit(img)
    hp, wp = out["grid"]
    return out["patch_tokens"].reshape(img.shape[0], hp, wp, -1).permute(0, 3, 1, 2)


def make_vit(backbone: str = "dinov2", backbone_type: str = "vit_small", patch_size: int = 14,
             attention_impl: str = "flash", dtype: torch.dtype = torch.bfloat16, device=None,
             generator: torch.Generator | None = None, state_dict: dict | None = None,
             quant: Optional[str] = None, ln_dtype: torch.dtype = torch.float32) -> VisionTransformer:
    """Instantiate by the reference's (backbone, backbone_type, patch_size).
    The reference's perf profile is attention_impl="xla_bf16" (or "auto")
    with ln_dtype=bfloat16; its bench builds the ViT with ln_dtype=bfloat16."""
    key = f"{backbone}_vit_{backbone_type.replace('vit_', '')}_{patch_size}"
    if key not in VIT_CONFIGS:
        raise ValueError(f"Unknown ViT config {key}; have {sorted(VIT_CONFIGS)}")
    return VisionTransformer(VIT_CONFIGS[key], attention_impl=attention_impl, dtype=dtype, device=device,
                             generator=generator, state_dict=state_dict, quant=quant, ln_dtype=ln_dtype)
