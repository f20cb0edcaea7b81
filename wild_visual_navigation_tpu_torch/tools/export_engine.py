"""Export an ahead-of-time inference engine.

Port of the repository's tools/export_engine.py, the reference's
TensorRT-engine workflow (build an engine offline, load and run it at
deploy time):

  1. build the per-patch pipeline: the DINO/DINOv2 ViT, then a SimpleMLP
     [D, 256, 32, 1] head with reconstruction, keeping its traversability
     output per patch, (B, 3, S, S) -> (B, S/p, S/p);
  2. export it with torch.export at the fixed deployment shape and compile
     it with AOTInductor (feature_extractor/aot_engine.py::AOTEngine;
     kernel K1 stays the operator wvn::flash_attention inside it);
  3. save the engine spec (weights, input contract, metadata) and the
     compiled package beside it (`<out>.pt2`), which
     aot_engine.load_engine loads without compiling.

Weights are seeded (pretrained DINO weights are not in the repository);
--head_ckpt loads a head from the estimator's checkpoint
(TraversabilityEstimator.save_checkpoint). The int8 backbones are built
through the Python API: `build_pipeline(..., quant="int8_static")`, then
`calibrate_int8_static(pipeline.vit, batches)` and `export_pipeline`.

Usage:
    python -m wild_visual_navigation_tpu_torch.tools.export_engine --size 224 --batch 1 \\
        --out results/engines_torch/dinov2_vits14_224.spec
    python -m wild_visual_navigation_tpu_torch.tools.export_engine --device cpu --size 56
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
from torch import nn

from ..feature_extractor.aot_engine import AOTEngine, enable_persistent_cache, save_engine_spec
from ..models.registry import get_model
from ..models.vit import dense_features, make_vit
from ..utils.devices import torch_device


class EnginePipeline(nn.Module):
    """ViT -> SimpleMLP per patch -> traversability, (B, Hp, Wp)."""

    def __init__(self, vit: nn.Module, head: nn.Module):
        super().__init__()
        self.vit, self.head = vit, head

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        feat = dense_features(self.vit, imgs)
        B, D, Hp, Wp = feat.shape
        return self.head(feat.permute(0, 2, 3, 1).reshape(-1, D))[:, 0].reshape(B, Hp, Wp)


def build_pipeline(backbone: str = "dinov2", backbone_type: str = "vit_small", patch_size: int = 14,
                   device="cuda", quant: Optional[str] = None, head_ckpt: Optional[str] = None,
                   seed: int = 0) -> EnginePipeline:
    """The pipeline with a seeded ViT (bf16 compute) and head, frozen."""
    device = torch.device(device)
    vit = make_vit(backbone, backbone_type, patch_size, device=device, quant=quant,
                   generator=torch.Generator().manual_seed(seed))
    D = vit.cfg.embed_dim
    head = get_model({"name": "SimpleMLP",
                      "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1], "reconstruction": True}},
                     device=device, generator=torch.Generator().manual_seed(seed + 1))
    if head_ckpt:
        payload = torch.load(head_ckpt, map_location=device, weights_only=True)
        head.load_state_dict(payload["params"])
        print(f"loaded head from {head_ckpt} (step {payload.get('step')})")
    return EnginePipeline(vit, head).eval().requires_grad_(False)


def pipeline_flops(pipeline: EnginePipeline, size: int, batch: int) -> int:
    """The pipeline's operations at (batch, 3, size, size), counted from its
    shapes: 2·M·N·K of every product (the patch embedding, the bicubic
    resize of the position table when the grid differs, qkv, proj, fc1, fc2,
    the head's layers) and 4·B·H·S²·d of attention. The elementwise work is
    not counted, as FlopCounterMode does not count it."""
    cfg = pipeline.vit.cfg
    ps, D, g = cfg.patch_size, cfg.embed_dim, cfg.pos_grid_size
    hp = size // ps
    P, N = hp * hp, hp * hp + 1 + cfg.num_register_tokens
    hidden = int(D * cfg.mlp_ratio)
    blocks = (2 * batch * N * D * (4 * D + 2 * hidden) + 4 * batch * N * N * D) * cfg.depth
    pos = 2 * hp * g * g * D + 2 * hp * hp * g * D if hp != g else 0
    head = sum(2 * batch * P * lin.in_features * lin.out_features for lin in pipeline.head.layers)
    return blocks + 2 * batch * P * 3 * ps * ps * D + pos + head


def export_pipeline(pipeline: EnginePipeline, size: int, batch: int) -> AOTEngine:
    """The engine compiled at the fixed input (batch, 3, size, size), float32."""
    device = next(pipeline.parameters()).device
    return AOTEngine(pipeline, torch.zeros((batch, 3, size, size), dtype=torch.float32, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", type=str, default="dinov2")
    ap.add_argument("--backbone_type", type=str, default="vit_small")
    ap.add_argument("--patch_size", type=int, default=14)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cache", type=str, default=None,
                    help="directory of the kernel library's build (default: the package's csrc/_build)")
    ap.add_argument("--out", type=str, default="results/engines_torch/engine.spec")
    ap.add_argument("--head_ckpt", type=str, default=None,
                    help="optional trained head checkpoint (TraversabilityEstimator.save_checkpoint)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    device = torch_device(args.device, "export_engine")
    if args.cache:
        enable_persistent_cache(args.cache)
    size = (args.size // args.patch_size) * args.patch_size
    pipeline = build_pipeline(args.backbone, args.backbone_type, args.patch_size, device, head_ckpt=args.head_ckpt)
    engine = export_pipeline(pipeline, size, args.batch)
    print(f"exported and compiled in {engine.compile_seconds:.1f}s; flops/call={engine.flops} "
          f"(analytic {pipeline_flops(pipeline, size, args.batch)})")

    example = torch.zeros(engine.input_shape, device=device)
    t0 = time.perf_counter()
    out = engine(example)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"first call: {(time.perf_counter() - t0) * 1e3:.1f} ms; output {tuple(out.shape)}")

    path = save_engine_spec(
        args.out, {"vit": pipeline.vit.state_dict(), "head": pipeline.head.state_dict()}, engine.input_shape,
        str(engine.input_dtype),
        meta={"backbone": args.backbone, "backbone_type": args.backbone_type, "patch_size": args.patch_size,
              "size": size, "cache": args.cache, "device": str(device)},
        engine=engine,
    )
    print(f"engine spec: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
