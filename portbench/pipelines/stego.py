"""The `stego` pipeline: the Jackal's STEGO model. DINO ViT-B/8, the STEGO
code head (a 90-d code), per-image cosine k-means over the codes as the
segments, a SimpleMLP head on the code scored at every pixel.

The six functions of a pipeline (see pipelines/dino.py):

  * make_weights(cfg, seed, device): "backbone" (the ViT), "stego_head"
    (the code head, models/stego_head.py's names) and "head" (the trained
    head on the 90-d code);
  * build_runtime(cfg, mix, weights, device, quant): the port's WVNRuntime
    in stego x stego, the STEGO head passed as `stego_head_params`;
  * frame(...): the plain reference for one camera frame;
  * num_segments(cfg): the k-means clusters;
  * frame_flops(cfg): the ViT, the code head and the per-pixel head;
  * kernel_shapes(cfg, mix): K1 and K2 (no SLIC, so no K3). K2's work does
    not depend on the head's input width (the D-channel contractions run
    before it, csrc/pixelwise_score.cu takes D as a scalar), so
    counts.k2_bound_s holds at the 90-d reconstruction as it is.

Nothing here but `build_runtime` imports the port, and nothing JAX.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

from portbench import reference as ref
from portbench.reference import Prec
from portbench.weights import _fill

_s = importlib.util.spec_from_file_location("portbench_pipeline_dino_of_stego",
                                            pathlib.Path(__file__).with_name("dino.py"))
dino = importlib.util.module_from_spec(_s)
_s.loader.exec_module(dino)


# ---------------------------------------------------------------- weights
def stego_head_shapes(embed_dim: int, st: dict) -> dict:
    """Name -> shape of the STEGO head's state dict: code = cluster1(f) +
    cluster2_fc2(relu(cluster2_fc1(f))), and the two probes over the code
    (unused by the frame, loaded with the rest)."""
    D, C, K = embed_dim, st["code_dim"], st["n_classes"]
    return {"cluster1.weight": (C, D), "cluster1.bias": (C,), "cluster2_fc1.weight": (D, D),
            "cluster2_fc1.bias": (D,), "cluster2_fc2.weight": (C, D), "cluster2_fc2.bias": (C,),
            "cluster_probe": (K, C), "linear_probe.weight": (K, C), "linear_probe.bias": (K,)}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{"backbone", "stego_head", "head"}: fp32 state dicts on `device`."""
    ss = np.random.SeedSequence([seed, 7]).generate_state(3)
    g = torch.Generator(device=device)
    m, st = cfg["model"], cfg["stego"]
    g.manual_seed(int(ss[0]))
    vit = _fill(dino.vit_shapes(m), g, device, m.get("layerscale"))
    g.manual_seed(int(ss[1]))
    code = _fill(stego_head_shapes(m["embed_dim"], st), g, device)
    g.manual_seed(int(ss[2]))
    head = _fill(dino.head_shapes(st["code_dim"], cfg["head"]["hidden_sizes"]), g, device)
    return {"backbone": vit, "stego_head": code, "head": head}


# ---------------------------------------------------------------- runtime
def build_runtime(cfg: dict, mix: dict, weights: dict, device, quant=None):
    """WVNRuntime in stego x stego at the configuration's settings; `quant`
    overrides the backbone's precision (the facade refuses any for STEGO)."""
    from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
    from wild_visual_navigation_tpu_torch.runtime.fused import KMEANS_ITERATIONS
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import confidence_init

    m, st, est, rates = cfg["model"], cfg["stego"], cfg["estimator"], dict(cfg["rates_hz"])
    # what StegoInterface and the fused STEGO frame build, whatever a configuration says
    fixed = {"backbone": (m["backbone"], "vit_base"), "patch_size": (m["patch_size"], 8),
             "code_dim": (st["code_dim"], 90), "n_classes": (st["n_classes"], 27), "clusters": (st["clusters"], 20),
             "kmeans_iterations": (st["kmeans_iterations"], KMEANS_ITERATIONS), "crf": (st["crf"], False)}
    wrong = {k: v for k, v in fixed.items() if v[0] != v[1]}
    if wrong:
        raise SystemExit(f"portbench: the port's STEGO frame cannot run {cfg['name']}: (asked, built) {wrong}")
    if mix.get("raise_rate_gates"):
        rates["image_callback"] = rates["supervision_callback"] = 1e9
    cams = {f"cam{c}": {"use_for_training": True, "scheduler_weight": 1} for c in range(int(mix.get("cameras", 1)))}
    size = cfg["image_size"]
    fe = FeatureExtractorNodeParams(
        camera_topics=cams, network_input_image_height=size, network_input_image_width=size,
        segmentation_type="stego", feature_type="stego", dino_patch_size=m["patch_size"],
        dino_backbone=m["backbone"], dino_quant=quant if quant is not None else cfg.get("quant"),
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
                    stego_head_params=weights["stego_head"], score_at_patch_res=cfg["score_at_patch_res"],
                    device=device, backbone_dtype=dtype)
    rt.adopt_train_state(weights["head"], None, confidence_init(device))
    return rt


# -------------------------------------------------------- plain reference
def code_head(sd: dict, tok: torch.Tensor, p: Prec) -> torch.Tensor:
    """(N, D) patch tokens -> (N, code_dim) STEGO codes, in float32."""
    def linear(x, name):
        return p.r(x) @ p.r(sd[name + ".weight"]).T + sd[name + ".bias"].float()

    return linear(tok, "cluster1") + linear(torch.relu(linear(tok, "cluster2_fc1")), "cluster2_fc2")


def kmeans_init(n_points: int, clusters: int) -> torch.Tensor:
    """The port's initial centres: the first `clusters` of a permutation of
    the points drawn from a torch.Generator seeded 0, the same every frame."""
    if clusters > n_points:
        raise ValueError(f"{clusters} clusters over {n_points} points")
    return torch.randperm(n_points, generator=torch.Generator().manual_seed(0))[:clusters]


def cosine_kmeans(code: torch.Tensor, init: torch.Tensor, iterations: int, p: Prec) -> torch.Tensor:
    """Lloyd steps of k-means on the unit codes (N, C) with cosine
    similarity: each point to its most similar unit centre (the first on
    ties), each centre to the mean of its points (an empty cluster keeps
    its centre); the labels (N,) after the last step's assignment."""
    def unit(x):
        x = p.e(x)
        return x / (torch.sqrt((x * x).sum(-1, keepdim=True)) + 1e-8)

    x = unit(code)
    centers = x[init.to(x.device)]
    S = centers.shape[0]
    for _ in range(iterations):
        labels = torch.argmax(p.r(x) @ p.r(unit(centers)).T, dim=-1)
        onehot = (labels[:, None] == torch.arange(S, device=x.device)[None, :]).float()
        sums = onehot.T @ p.r(x)
        counts = onehot.sum(0)[:, None]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    return torch.argmax(p.r(x) @ p.r(unit(centers)).T, dim=-1)


def frame(cfg: dict, weights: dict, head: dict, mean, std, img_u8: torch.Tensor, p: Prec) -> dict:
    """One camera frame: (3, H0, W0) uint8 -> traversability and confidence
    maps (H, W), the cluster ids (H, W) and the codes pooled per cluster
    (S, 90) with their validity.

    STEGO (Hamilton et al., ICLR 2022) as the Jackal runs it, with these
    departures from the published model: no CRF refinement (the
    configuration's `crf` false, as the robot's runtime runs it); k-means'
    initial centres are the port's fixed draw (`kmeans_init`), not a fresh
    random draw per image; the segments are the k-means clusters of each
    image, not the cluster probe's classes."""
    H, m, st = cfg["image_size"], cfg["model"], cfg["stego"]
    x = ref.resize_square(ref.to_unit(img_u8), H)
    tok = dino.vit_patch_tokens(weights["backbone"], m, ref.normalize(x)[None], p)[0]
    code = code_head(weights["stego_head"], tok, p)
    hp = H // m["patch_size"]
    S = st["clusters"]
    labels = cosine_kmeans(code, kmeans_init(hp * hp, S), st["kmeans_iterations"], p)
    seg_p = labels.reshape(hp, hp)
    rows = (torch.arange(H, device=x.device) * hp) // H  # the integer nearest upsample (y · hp) // H
    seg = seg_p[rows][:, rows].to(torch.int32)
    feat = code.T.reshape(-1, hp, hp)
    pooled, counts = ref.pool_patches(feat, seg_p, S, p)
    dense = ref.upsample(feat, H, H, p)
    t, c = ref.score_rows(head, dense.reshape(dense.shape[0], -1).T, mean, std, cfg["confidence"]["std_factor"], p)
    return {"trav": t.reshape(H, H), "conf": c.reshape(H, H), "seg": seg, "features": pooled,
            "feat_valid": counts > 0}


def num_segments(cfg: dict) -> int:
    return cfg["stego"]["clusters"]


# ----------------------------------------------------------------- counts
def code_head_flops(cfg: dict) -> float:
    """The code head on every patch token: two D -> code_dim products and one D -> D."""
    D, C = cfg["model"]["embed_dim"], cfg["stego"]["code_dim"]
    n_patch = (cfg["image_size"] // cfg["model"]["patch_size"]) ** 2
    return n_patch * 2 * (2 * D * C + D * D)


def head_flops(cfg: dict) -> float:
    """The SimpleMLP on the code at every pixel."""
    C = cfg["stego"]["code_dim"]
    sizes = [C, *cfg["head"]["hidden_sizes"][:-1], cfg["head"]["hidden_sizes"][-1] + C]
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:])) * cfg["image_size"] ** 2


def frame_flops(cfg: dict) -> float:
    return dino.vit_flops(cfg) + code_head_flops(cfg) + head_flops(cfg)


def kernel_shapes(cfg: dict, mix: dict) -> dict:
    """K1 at (cameras, heads, tokens, head dim); K2 at (cameras, patch rows,
    H, W, the head's first two widths); no K3."""
    B, H, m = int(mix.get("cameras", 1)), cfg["image_size"], cfg["model"]
    hidden = cfg["head"]["hidden_sizes"]
    return {"k1": (B, m["num_heads"], dino.tokens(cfg), m["embed_dim"] // m["num_heads"]),
            "k2": (B, H // m["patch_size"], H, H, hidden[0], hidden[1])}
