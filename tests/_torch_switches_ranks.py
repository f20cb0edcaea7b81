"""Rank body for tests/test_torch_port_switches.py's mesh case.

It runs on one rank of a Gloo process group on the CPU
(wild_visual_navigation_tpu_torch/parallel/launch.py::run_ranks spawns it;
this module is imported by name in every rank, so it imports no JAX) and
returns numpy values for the test process to compare.
"""

import numpy as np
import torch

from wild_visual_navigation_tpu_torch.models import vit as tvit
from wild_visual_navigation_tpu_torch.parallel import create_mesh, shard_module, vit_param_spec

# 6 heads of 16 over tp 2; 184 px at patch 8 is 23 x 23 + 1 = 530 tokens
MESH_VIT = dict(patch_size=8, embed_dim=96, depth=1, num_heads=6, pos_grid_size=4, layerscale_init=None)


def auto_mesh_rank(rank: int, world: int, state: dict, imgs: np.ndarray) -> dict:
    """A rank of a (dp 2, tp 2) mesh: its tp share of an "auto" ViT's heads
    on its dp share of the frames; the shapes "auto" resolved on."""
    mesh = create_mesh(dp=2, tp=2, device="cpu")
    vit = tvit.VisionTransformer(tvit.ViTConfig(**MESH_VIT), attention_impl="auto", dtype=torch.float32,
                                 state_dict=state)
    shard_module(vit, vit_param_spec(vit, tp=2), mesh)
    dp = mesh.get_local_rank("dp")
    n = imgs.shape[0] // 2
    with torch.no_grad():
        feats = vit(torch.from_numpy(imgs[dp * n:(dp + 1) * n]))["patch_tokens"].numpy()
    return {"dp": dp, "heads": vit.blocks[0].attn.num_heads, "feats": feats,
            "resolved": sorted(tvit._AUTO_RESOLVED_LOGGED)}
