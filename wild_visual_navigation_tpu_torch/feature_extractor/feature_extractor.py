"""FeatureExtractor facade: image -> (edges, features, segments, centers).

Port of wild_visual_navigation_tpu/feature_extractor/feature_extractor.py
for the DINO / DINOv2, STEGO and torchvision (ResNet, EfficientNet)
backbones, dense SIFT and the colour histogram, and the slic, grid, none (pixel-wise), random and stego
segmentations. Every output keeps the JAX
package's fixed shapes: `num_segments` is a static capacity, the
per-segment feature matrix is (S, D) with a validity mask.

SLIC on a CUDA image runs `ops/slic.py::slic`, which hands it to
`slic_batch` and so to kernel K3; the plain whole-image loop serves CPU
images only. The stego segmentation is the STEGO interface's per-image
k-means clusters; in stego × stego mode the features computed while
segmenting are reused. SIFT (`feature_extractor/sift.py`, 128 per RGB
channel) and the histogram (`ops/histogram.py`, 90 HSV bins) are dense
fields computed on the image's device with no weights. The torchvision
features are a CNN pyramid (feature_extractor/torchvision_interface.py:
ResNet-18 unless `model_type` says otherwise), pooled per segment over
its levels (ops/segment_ops.py::segment_pyramid_pool); that mode has no
dense per-pixel field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models.resnet import pyramid_feature_dim
from ..ops import segment_ops
from ..ops import slic as slic_ops
from ..ops.histogram import HIST_DIM, dense_color_histogram
from .dino import DinoInterface
from .sift import dense_sift_features
from .stego import StegoInterface
from .torchvision_interface import TorchVisionInterface


@dataclass
class Extraction:
    """Fixed-shape extraction result for one image."""

    edges: torch.Tensor  # (2, E) int32
    edge_valid: torch.Tensor  # (E,) bool
    features: Optional[torch.Tensor]  # (S, D) per-segment means (or (HW, D) pixel-wise)
    segments: torch.Tensor  # (H, W) int32 ids
    centers: torch.Tensor  # (S, 2) float (x, y)
    center_valid: torch.Tensor  # (S,) bool: the segment exists
    dense_features: Optional[torch.Tensor] = None  # (D, H, W)


class FeatureExtractor:
    def __init__(
        self,
        seed: int = 42,
        segmentation_type: str = "slic",
        feature_type: str = "dino",
        input_size: int = 448,
        device="cuda",
        **kwargs,
    ):
        """The JAX facade's arguments with `seed` (backbone weights and the
        random segmentation) in place of its `key`, and `device`. Extra
        keyword `dtype` sets the backbone's compute type (bf16 by default,
        as in the JAX package)."""
        if segmentation_type == "stego" and feature_type != "stego":
            raise ValueError(f"segmentation_type [stego] needs feature_type [stego] (got [{feature_type}])")
        self._segmentation_type = segmentation_type
        self._feature_type = feature_type
        self._input_size = input_size
        self._seed = seed
        self.device = torch.device(device)

        if feature_type == "stego":
            if kwargs.get("quant") is not None:
                # the STEGO ViT has no quantised path: refuse in place of running bf16 under an int8 name
                raise ValueError(f"feature_type [stego] has no quantised backbone (got quant [{kwargs['quant']}])")
            self._extractor = StegoInterface(
                seed=seed,
                input_size=input_size,
                n_image_clusters=kwargs.get("n_image_clusters", 20),
                run_clustering=kwargs.get("run_clustering", True),
                run_crf=kwargs.get("run_crf", False),
                backbone_params=kwargs.get("backbone_params"),
                head_params=kwargs.get("head_params"),
                attention_impl=kwargs.get("attention_impl") or "flash",
                dtype=kwargs.get("dtype", torch.bfloat16),
                device=self.device,
            )
            self._feature_dim = 90
        elif "dino" in feature_type:
            self._extractor = DinoInterface(
                backbone=kwargs.get("backbone", feature_type),
                input_size=input_size,
                backbone_type=kwargs.get("backbone_type", "vit_small"),
                patch_size=kwargs.get("patch_size", 8 if feature_type == "dino" else 14),
                params=kwargs.get("backbone_params"),
                attention_impl=kwargs.get("attention_impl") or "flash",
                dtype=kwargs.get("dtype", torch.bfloat16),
                device=self.device,
                seed=seed,
                quant=kwargs.get("quant"),
            )
            self._feature_dim = self._extractor.feature_dim
        elif feature_type == "torchvision":
            self._extractor = TorchVisionInterface(
                model_type=kwargs.get("model_type", "resnet18"),
                input_size=input_size,
                params=kwargs.get("backbone_params"),
                dtype=kwargs.get("dtype", torch.bfloat16),
                device=self.device,
                seed=seed,
            )
            self._feature_dim = self._extractor.feature_dim
        elif feature_type == "sift":
            self._extractor = None
            self._feature_dim = 384  # 128 per RGB channel
        elif feature_type == "histogram":
            self._extractor = None
            self._feature_dim = HIST_DIM
        elif feature_type == "none":
            self._extractor = None
            self._feature_dim = 0
        else:
            raise ValueError(f"feature_type [{feature_type}] not supported")

        self._slic_num_components = kwargs.get("slic_num_components", 100)
        self._slic_compactness = kwargs.get("slic_compactness", 10)
        self._cell_size = kwargs.get("cell_size", 32)
        self._n_random_pixels = kwargs.get("n_random_pixels", 100)
        self._max_edges = kwargs.get("max_edges", 1024)

    # -------------------------------------------------------- properties
    @property
    def feature_type(self) -> str:
        return self._feature_type

    @property
    def feature_dim(self) -> int:
        return self._feature_dim

    @property
    def segmentation_type(self) -> str:
        return self._segmentation_type

    def calibrate(self, sample_batches) -> bool:
        """Calibrate a statically quantised backbone (quant="int8_static",
        the dino modes only) on (B, 3, H, W) RGB frames in [0, 1], once
        before inference; False, doing nothing, for every other backbone."""
        calibrate = getattr(self._extractor, "calibrate", None)
        return calibrate(sample_batches) if calibrate is not None else False

    def num_segments(self, height: int, width: int) -> int:
        """Static per-image segment capacity for the configured mode."""
        return static_num_segments(self._segmentation_type, height, width, cell_size=self._cell_size,
                                   slic_num_components=self._slic_num_components,
                                   n_random_pixels=self._n_random_pixels,
                                   n_image_clusters=getattr(self._extractor, "n_image_clusters", 20))

    # ------------------------------------------------------------- steps
    def compute_segments(self, img: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(1, 3, H, W) -> (edges, edge_valid, seg (H, W), centers,
        center_valid). `generator` draws the random segmentation; without
        one every call draws from `seed`, as the JAX facade reuses its key."""
        H, W = img.shape[2], img.shape[3]
        st = self._segmentation_type
        dev = img.device
        if st in ("none", None):
            seg = segment_ops.segment_pixelwise(H, W, dev)
            edges = segment_ops.pixelwise_edges(H, W, dev)
            ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W).reshape(-1)
            xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W).reshape(-1)
            centers = torch.stack([xs, ys], dim=-1)
            return (edges, torch.ones(edges.shape[1], dtype=torch.bool, device=dev), seg, centers,
                    torch.ones(H * W, dtype=torch.bool, device=dev))
        if st == "grid":
            seg = segment_ops.segment_grid(H, W, self._cell_size, device=dev)
        elif st == "slic":
            seg = slic_ops.slic(img[0], num_components=self._slic_num_components, compactness=self._slic_compactness)
        elif st == "random":
            if generator is None:
                generator = torch.Generator().manual_seed(self._seed)
            seg = segment_ops.segment_random(generator, H, W, self._n_random_pixels, device=dev)
        elif st == "stego":
            self._extractor.inference(img)
            seg = self._extractor.cluster_segments[0]
        else:
            raise ValueError(f"segmentation_type [{st}] not supported")

        S = self.num_segments(H, W)
        edges, edge_valid = segment_ops.adjacency_list(seg, S, max_edges=self._max_edges)
        centers, center_valid = segment_ops.segment_centers(seg, S)
        return edges, edge_valid, seg, centers, center_valid

    def compute_features(self, img: torch.Tensor):
        """(1, 3, H, W) -> (D, H, W) dense features (None for "none"); for
        torchvision the level dict {name: (C_i, H_i, W_i)}, which `extract`
        pools across levels."""
        if self._feature_type == "torchvision":
            return {k: v[0] for k, v in self._extractor.inference(img).items()}
        if self._feature_type == "sift":
            return dense_sift_features(img[0])
        if self._feature_type == "histogram":
            return dense_color_histogram(img[0])
        if self._extractor is None:
            return None
        if self._feature_type == "stego":
            # stego x stego reuses the features computed while segmenting
            # (the reference's _stego_features_already_computed flag)
            if self._segmentation_type != "stego" or self._extractor.features is None:
                self._extractor.inference(img)
            return self._extractor.features[0]
        return self._extractor.inference(img)[0]

    def sparsify_features(self, dense_features: torch.Tensor, seg: torch.Tensor, num_segments: int):
        """Per-segment mean pooling -> ((S, D), counts)."""
        return segment_ops.segment_mean_pool(dense_features, seg, num_segments)

    # -------------------------------------------------------------- main
    @torch.no_grad()
    def extract(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_dense_features: bool = False) -> Extraction:
        """img: (1, 3, H, W) RGB in [0, 1] float (uint8 accepted and
        converted on its device)."""
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        H, W = img.shape[2], img.shape[3]
        edges, edge_valid, seg, centers, center_valid = self.compute_segments(img, generator)
        dense = self.compute_features(img)
        if isinstance(dense, dict):
            # the CNN pyramid: per-segment pooling across levels
            feat, _ = segment_ops.segment_pyramid_pool(dense, seg, self.num_segments(H, W))
            dense = None
        elif dense is None:
            feat = None
        elif self._segmentation_type in ("none", None):
            feat = dense.reshape(dense.shape[0], -1).T  # (HW, D)
        else:
            feat, _ = self.sparsify_features(dense, seg, self.num_segments(H, W))
        return Extraction(edges=edges, edge_valid=edge_valid, features=feat, segments=seg, centers=centers,
                          center_valid=center_valid, dense_features=dense if return_dense_features else None)


def static_feature_dim(feature_type: str, backbone_type: str = "vit_small", model_type: str = "resnet18") -> int:
    """Feature dimensionality without building a backbone, for a learning
    process that receives features already extracted."""
    if feature_type == "stego":
        return 90
    if feature_type in ("dino", "dinov2"):
        return {"vit_tiny": 192, "vit_small": 384, "vit_base": 768, "vit_large": 1024}[backbone_type]
    if feature_type == "torchvision":
        return pyramid_feature_dim(model_type)
    if feature_type == "sift":
        return 384  # 128 per RGB channel
    if feature_type == "histogram":
        return HIST_DIM  # hue x saturation x value bins
    raise ValueError(feature_type)


def static_num_segments(segmentation_type: str, height: int, width: int, cell_size: int = 32,
                        slic_num_components: int = 100, n_random_pixels: int = 100,
                        n_image_clusters: int = 20) -> int:
    """FeatureExtractor.num_segments without an instance."""
    st = segmentation_type
    if st == "slic":
        return slic_num_components
    if st == "grid":
        return (-(-height // cell_size)) * (-(-width // cell_size))
    if st == "random":
        return n_random_pixels
    if st == "stego":
        return n_image_clusters
    if st in ("none", None):
        return height * width
    raise ValueError(st)
