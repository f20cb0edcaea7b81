"""STEGO segmentation interface: ViT-B/8, the STEGO head and clustering.

Port of wild_visual_navigation_tpu/feature_extractor/stego.py. `inference`
resizes the smaller edge (nearest) and centre-crops to `input_size`, runs
the ViT and the head, clusters each image's codes with cosine k-means (or
takes the cluster probe's classes), and returns the bilinear upsample of
the 90-d code and the nearest upsample of the segmentations, optionally
refined by the mean-field CRF.

Weights are random from `seed` unless state dicts are given
(utils/params.py::vit_state_from_jax and ::stego_head_state_from_jax):
the STEGO checkpoint is not in the repository.

k-means' initial indices: the JAX package draws them per image from
`jax.random.split(PRNGKey(0), B)` on every call; the port draws them from
a `torch.Generator` seeded 0, once per (B, N), or takes them from the
caller (`init_idx`).
"""

from __future__ import annotations

import torch

from ..models.stego_head import StegoHead, cosine_kmeans, kmeans_init_indices
from ..models.vit import make_vit
from ..ops.resize import (
    _nearest_indices,
    center_crop,
    imagenet_normalize,
    interpolate_bilinear,
    resize_image,
    resize_smaller_edge_nearest,
)


class StegoInterface:
    def __init__(self, seed: int = 0, input_size: int = 448, n_image_clusters: int = 20, run_clustering: bool = True,
                 run_crf: bool = False, backbone_params: dict | None = None, head_params: dict | None = None,
                 attention_impl: str = "flash", dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self._input_size = input_size
        self._n_image_clusters = n_image_clusters
        self._run_clustering = run_clustering
        self._run_crf = run_crf
        self.device = torch.device(device)
        # the STEGO-cocostuff27 checkpoint's backbone, DINO ViT-B/8; the ViT and
        # the head draw from generators of their own, as JAX splits its key
        self.vit = make_vit("dino", "vit_base", 8, attention_impl=attention_impl, dtype=dtype, device=self.device,
                            generator=torch.Generator().manual_seed(seed), state_dict=backbone_params)
        self.head = StegoHead(in_dim=self.vit.cfg.embed_dim, code_dim=90, n_classes=27, device=self.device,
                              generator=torch.Generator().manual_seed(seed))
        if head_params is not None:
            self.head.load_state_dict(head_params)
        self.vit.eval().requires_grad_(False)
        self.head.eval().requires_grad_(False)
        self._init_cache: dict = {}
        self._features = self._cluster_segments = self._linear_segments = None

    @property
    def input_size(self) -> int:
        return self._input_size

    @property
    def n_image_clusters(self) -> int:
        return self._n_image_clusters

    def kmeans_init(self, batch: int, n_points: int) -> torch.Tensor:
        """(batch, S) initial indices, one draw per image, on the device."""
        key = (batch, n_points)
        if key not in self._init_cache:
            g = torch.Generator().manual_seed(0)
            draws = [kmeans_init_indices(g, n_points, self._n_image_clusters) for _ in range(batch)]
            self._init_cache[key] = torch.stack(draws).to(self.device)
        return self._init_cache[key]

    @torch.no_grad()
    def inference(self, img: torch.Tensor, init_idx: torch.Tensor | None = None):
        """img (B, 3, H, W) in [0, 1] -> (features (B, 90, H', W'), cluster
        segments (B, H', W') int32); also sets .features, .cluster_segments
        and .linear_segments. The ViT sees the square centre crop. Raw images
        keep the reference's square (H, H) output; inputs already at network
        size (smaller edge == input_size) upsample to the full (H, W)."""
        B, _, H, W = img.shape
        if min(H, W) != self._input_size:
            W = H  # the reference's raw-image semantics: square maps
        x = center_crop(resize_smaller_edge_nearest(img, self._input_size), self._input_size)
        out = self.vit(imagenet_normalize(x))
        hp, wp = out["grid"]
        res = self.head(out["patch_tokens"])
        code = res["code"]  # (B, N, 90)
        linear_pred = torch.argmax(res["linear_logits"], dim=-1)
        if self._run_clustering:
            idx = self.kmeans_init(B, hp * wp) if init_idx is None else init_idx
            labels, _ = cosine_kmeans(code, idx)
        else:
            labels = torch.argmax(res["cluster_logits"], dim=-1)
        code_up = interpolate_bilinear(code.reshape(B, hp, wp, -1).permute(0, 3, 1, 2), H, W)

        # the float rule floor(i · (hp / H)), as the reference's nearest upsample
        iy = _nearest_indices(H, hp, img.device)
        ix = _nearest_indices(W, wp, img.device)

        def up_nearest(pred):
            return pred.reshape(B, hp, wp).to(torch.int32)[:, iy][:, :, ix]

        cluster, linear = up_nearest(labels), up_nearest(linear_pred)
        if self._run_crf:
            from ..ops.crf import crf_refine_labels

            guide = resize_image(img, H, W)
            n_cls = self._n_image_clusters if self._run_clustering else 27
            cluster = torch.stack([crf_refine_labels(cluster[b], guide[b], n_cls) for b in range(B)])
            linear = torch.stack([crf_refine_labels(linear[b], guide[b], 27) for b in range(B)])
        self._features, self._cluster_segments, self._linear_segments = code_up, cluster, linear
        return code_up, cluster

    @property
    def features(self):
        return self._features

    @property
    def cluster_segments(self):
        return self._cluster_segments

    @property
    def linear_segments(self):
        return self._linear_segments
