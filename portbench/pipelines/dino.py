"""The `dino` pipeline: a DINO or DINOv2 ViT backbone, SLIC or grid
segments, a SimpleMLP head scored at every pixel or at every patch.

A configuration names its pipeline with the key "pipeline" (this one where
the key is absent); the harness finds `pipelines/<pipeline>.py` by that
name and calls these functions of it:

  * make_weights(cfg, seed, device): the seeded fp32 state dicts by name,
    here "backbone" (the ViT) and "head" (the trained head);
  * build_runtime(cfg, mix, weights, device, quant): the port's
    WVNRuntime, the one function that imports the port (in its body);
  * frame(cfg, weights, head, mean, std, img_u8, p): the plain reference
    for one camera frame (`trav`, `conf`, `seg`, `features`, `feat_valid`);
  * num_segments(cfg): the S of the buffer and the flush;
  * frame_flops(cfg): one camera frame's model FLOPs;
  * kernel_shapes(cfg, mix): the shapes of the kernels the frame launches,
    by the names of portbench/counts.py's bounds (k1, k2, k3).

Nothing here but `build_runtime` imports the port, and nothing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as ref
from portbench.reference import Prec, layer_norm
from portbench.weights import _fill


# ---------------------------------------------------------------- weights
def vit_shapes(m: dict) -> dict:
    """Name -> shape of the ViT state dict for the configuration's `model`,
    with the torch-hub DINO / DINOv2 names the port loads."""
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
    """Name -> shape of a SimpleMLP's state dict (`layers.N.weight`)."""
    sizes = [input_size, *hidden_sizes[:-1], hidden_sizes[-1] + input_size]
    out = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"layers.{i}.weight"] = (b, a)
        out[f"layers.{i}.bias"] = (b,)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{"backbone": the ViT's state dict, "head": the head's}, fp32, on `device`."""
    ss = np.random.SeedSequence([seed, 5]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(ss[0]))
    vit = _fill(vit_shapes(cfg["model"]), g, device, cfg.get("layerscale", cfg["model"].get("layerscale")))
    g.manual_seed(int(ss[1]))
    head = _fill(head_shapes(cfg["model"]["embed_dim"], cfg["head"]["hidden_sizes"]), g, device)
    return {"backbone": vit, "head": head}


# ---------------------------------------------------------------- runtime
def build_runtime(cfg: dict, mix: dict, weights: dict, device, quant=None):
    """WVNRuntime at the configuration's settings, `quant` overriding its
    backbone precision (the control's int8 path)."""
    from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import confidence_init

    m, seg, est, rates = cfg["model"], cfg["segmentation"], cfg["estimator"], dict(cfg["rates_hz"])
    if mix.get("raise_rate_gates"):
        rates["image_callback"] = rates["supervision_callback"] = 1e9
    cams = {f"cam{c}": {"use_for_training": True, "scheduler_weight": 1} for c in range(int(mix.get("cameras", 1)))}
    size = cfg["image_size"]
    fe = FeatureExtractorNodeParams(
        camera_topics=cams, network_input_image_height=size, network_input_image_width=size,
        segmentation_type=seg["type"], feature_type=m["family"], dino_patch_size=m["patch_size"],
        dino_backbone=m["backbone"], dino_quant=quant if quant is not None else cfg.get("quant"),
        slic_num_components=seg["num_segments"], grid_cell_size=seg.get("cell_size", 32),
        prediction_per_pixel=cfg["prediction_per_pixel"], image_callback_rate=rates["image_callback"])
    ln = LearningNodeParams(
        camera_topics=cams, network_input_image_height=size, network_input_image_width=size,
        robot_length=cfg["robot"]["length"], robot_width=cfg["robot"]["width"], robot_height=cfg["robot"]["height"],
        traversability_radius=est["traversability_radius"], image_graph_dist_thr=est["image_graph_dist_thr"],
        supervision_graph_dist_thr=est["supervision_graph_dist_thr"],
        confidence_std_factor=cfg["confidence"]["std_factor"],
        min_samples_for_training=est["min_samples_for_training"],
        supervision_callback_rate=rates["supervision_callback"], learning_thread_rate=rates["learning_thread"],
        logging_thread_rate=rates["logging_thread"], load_save_checkpoint_rate=rates["load_save_checkpoint"])
    exp = ExperimentParams()
    exp.optimizer.lr = est["lr"]
    exp.ablation_data_module.batch_size = est["batch_size"]
    exp.loss.w_trav, exp.loss.w_reco = cfg["loss"]["w_trav"], cfg["loss"]["w_reco"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    rt = WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, buffer_capacity=est["buffer_capacity"],
                    reprojection_fanout=est["reprojection_fanout"], backbone_params=weights["backbone"],
                    score_at_patch_res=cfg["score_at_patch_res"], device=device, backbone_dtype=dtype)
    rt.adopt_train_state(weights["head"], None, confidence_init(device))
    return rt


# -------------------------------------------------------- plain reference
def _bicubic_matrix(n_in: int, n_out: int, offset: float = 0.1) -> np.ndarray:
    """torch's bicubic upsample (a = -0.75, scale (n_out + offset) / n_in,
    clamped borders) as DINO's interpolate_pos_encoding calls it."""
    a = -0.75

    def cubic(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
        if x < 2.0:
            return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
        return 0.0

    scale = n_in / (n_out + offset)
    M = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(x))
        for off in (-1, 0, 1, 2):
            M[i, min(max(i0 + off, 0), n_in - 1)] += cubic(x - i0 - off)
    return M


def vit_patch_tokens(sd: dict, m: dict, img: torch.Tensor, p: Prec) -> torch.Tensor:
    """Normalised (B, 3, H, W) -> final-norm patch tokens (B, hp·wp, D):
    pre-norm blocks, exact GELU, optional layer scale, bicubic
    position-table resize."""
    B, _, H, W = img.shape
    ps, D, heads = m["patch_size"], m["embed_dim"], m["num_heads"]
    hp, wp = H // ps, W // ps
    x = img[:, :, :hp * ps, :wp * ps].reshape(B, 3, hp, ps, wp, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, hp * wp, 3 * ps * ps)
    w = sd["patch_embed.proj.weight"].reshape(D, -1)
    x = p.a(p.a(x) @ p.a(w).T + sd["patch_embed.proj.bias"].float())
    G = m["pos_grid_size"]
    pos = sd["pos_embed"][0, 1:].float()
    if (hp, wp) != (G, G):
        grid = pos.reshape(G, G, D)
        Mh = torch.as_tensor(_bicubic_matrix(G, hp), device=img.device)
        Mw = torch.as_tensor(_bicubic_matrix(G, wp), device=img.device)
        pos = torch.einsum("pj,ojd->opd", Mw, torch.einsum("oi,ijd->ojd", Mh, grid)).reshape(hp * wp, D)
    x = x + pos[None]
    tokens = [(sd["cls_token"] + sd["pos_embed"][:, :1]).float().expand(B, 1, D)]
    R = m.get("num_register_tokens", 0)
    if R:
        tokens.append(sd["register_tokens"].float().expand(B, R, D))
    x = torch.cat(tokens + [x], dim=1)
    N, Dh, eps = x.shape[1], D // heads, m["ln_eps"]
    for i in range(m["depth"]):
        b = f"blocks.{i}."
        h = layer_norm(x, sd[b + "norm1.weight"], sd[b + "norm1.bias"], eps)
        qkv = p.vit_linear(h, sd[b + "attn.qkv.weight"], sd[b + "attn.qkv.bias"])
        q, k, v = qkv.reshape(B, N, 3, heads, Dh).permute(2, 0, 3, 1, 4).unbind(0)
        att = torch.softmax((q @ k.transpose(-1, -2)) * Dh**-0.5, dim=-1)
        o = p.a(p.a(att) @ v).transpose(1, 2).reshape(B, N, D)
        o = p.vit_linear(o, sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"])
        x = p.a(x + (o * sd[b + "ls1.gamma"].float() if b + "ls1.gamma" in sd else o))
        h = layer_norm(x, sd[b + "norm2.weight"], sd[b + "norm2.bias"], eps)
        h = torch.nn.functional.gelu(p.vit_linear(h, sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"]))
        h = p.vit_linear(h, sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"])
        x = p.a(x + (h * sd[b + "ls2.gamma"].float() if b + "ls2.gamma" in sd else h))
    x = layer_norm(x, sd["norm.weight"], sd["norm.bias"], eps)
    return x[:, 1 + R:]


def frame(cfg: dict, weights: dict, head: dict, mean, std, img_u8: torch.Tensor, p: Prec) -> dict:
    """One camera frame: (3, H0, W0) uint8 -> traversability and confidence
    maps (H, W), the segment ids (H, W) and the pooled segment features
    (S, D) with their validity, as the configuration computes them."""
    H = cfg["image_size"]
    x = ref.resize_square(ref.to_unit(img_u8), H)
    tok = vit_patch_tokens(weights["backbone"], cfg["model"], ref.normalize(x)[None], p)[0]
    ps = cfg["model"]["patch_size"]
    Hp = Wp = H // ps
    feat = tok.T.reshape(-1, Hp, Wp)
    seg_cfg = cfg["segmentation"]
    S = seg_cfg["num_segments"]
    if seg_cfg["type"] == "slic":
        seg = ref.slic(x, S, seg_cfg["compactness"], seg_cfg["iterations"], p)
    else:
        seg = ref.grid_segments(H, H, seg_cfg["cell_size"], x.device)
    sf = cfg["confidence"]["std_factor"]
    if cfg["score_at_patch_res"]:
        ph = H // Hp
        pooled, counts = ref.pool_patches(feat, seg[ph // 2::ph, ph // 2::ph][:Hp, :Wp], S, p)
        t, c = ref.score_rows(head, feat.reshape(feat.shape[0], -1).T, mean, std, sf, p)
        M = ref.bilinear_matrix(H, Hp, x.device)
        trav = (M @ t.reshape(Hp, Wp) @ M.T)
        conf = (M @ c.reshape(Hp, Wp) @ M.T)
    else:
        pooled, counts = ref.pool_upsampled(feat, seg, S, p)
        dense = ref.upsample(feat, H, H, p)
        t, c = ref.score_rows(head, dense.reshape(dense.shape[0], -1).T, mean, std, sf, p)
        trav, conf = t.reshape(H, H), c.reshape(H, H)
    return {"trav": trav, "conf": conf, "seg": seg, "features": pooled, "feat_valid": counts > 0}


def num_segments(cfg: dict) -> int:
    return cfg["segmentation"]["num_segments"]


# ----------------------------------------------------------------- counts
def tokens(cfg: dict) -> int:
    m = cfg["model"]
    g = cfg["image_size"] // m["patch_size"]
    return g * g + 1 + m.get("num_register_tokens", 0)


def vit_flops(cfg: dict) -> float:
    """One frame's ViT forward at its published widths: the patch
    embedding, then per block qkv, QKᵀ, PV, proj and the MLP (2 per multiply-add)."""
    m = cfg["model"]
    N, D, p = tokens(cfg), m["embed_dim"], m["patch_size"]
    hidden = int(D * m["mlp_ratio"])
    n_patch = (cfg["image_size"] // p) ** 2
    block = 2 * N * D * 3 * D + 2 * 2 * N * N * D + 2 * N * D * D + 2 * 2 * N * D * hidden
    return 2 * n_patch * 3 * p * p * D + m["depth"] * block


def head_flops(cfg: dict) -> float:
    """The head scored at the configuration's resolution: every pixel, or every patch."""
    D = cfg["model"]["embed_dim"]
    sizes = [D, *cfg["head"]["hidden_sizes"][:-1], cfg["head"]["hidden_sizes"][-1] + D]
    per_row = sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    g = cfg["image_size"] // cfg["model"]["patch_size"]
    rows = g * g if cfg["score_at_patch_res"] else cfg["image_size"] ** 2
    return per_row * rows


def frame_flops(cfg: dict) -> float:
    return vit_flops(cfg) + head_flops(cfg)


def kernel_shapes(cfg: dict, mix: dict) -> dict:
    """K1 at (cameras, heads, tokens, head dim); K2, the per-pixel scorer,
    where the head is scored at every pixel, at (cameras, patch rows, H, W,
    the head's first two widths); K3, the SLIC step, with SLIC segments, at
    (cameras, H, W, segments)."""
    B, H, m = int(mix.get("cameras", 1)), cfg["image_size"], cfg["model"]
    out = {"k1": (B, m["num_heads"], tokens(cfg), m["embed_dim"] // m["num_heads"])}
    if cfg["prediction_per_pixel"] and not cfg["score_at_patch_res"]:
        hidden = cfg["head"]["hidden_sizes"]
        out["k2"] = (B, H // m["patch_size"], H, H, hidden[0], hidden[1])
    if cfg["segmentation"]["type"] == "slic":
        out["k3"] = (B, H, H, num_segments(cfg))
    return out
