"""DINO / DINOv2 dense-feature interface.

Port of wild_visual_navigation_tpu/feature_extractor/dino.py: nearest
resize + centre crop + ImageNet normalisation, the frozen ViT, and a
bilinear (align_corners) upsample of the patch features.

Weights are random from `seed` unless `params` (a models/vit.py
state_dict, e.g. from utils/params.py::vit_state_from_jax) is given:
pretrained DINO weights are not in the repository.

`quant` ("int8" or "int8_static") builds the W8A8 backbone
(models/quant.py); a static one needs `calibrate` on sample frames before
inference, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..models.vit import VisionTransformer, calibrate_int8_static, make_vit
from ..ops.resize import center_crop, imagenet_normalize, interpolate_bilinear, resize_smaller_edge_nearest


class DinoInterface:
    def __init__(self, backbone: str = "dino", input_size: int = 448, backbone_type: str = "vit_small",
                 patch_size: int = 8, attention_impl: str = "flash", params: dict | None = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0, quant: str | None = None):
        self._input_size = input_size
        self._backbone = backbone
        self._backbone_type = backbone_type
        self._patch_size = patch_size
        self._quant = quant
        self.device = torch.device(device)
        generator = torch.Generator().manual_seed(seed)
        self.vit: VisionTransformer = make_vit(backbone, backbone_type, patch_size, attention_impl=attention_impl,
                                               dtype=dtype, device=self.device, generator=generator,
                                               state_dict=params, quant=quant)
        self.vit.eval().requires_grad_(False)

    @property
    def feature_dim(self) -> int:
        return self.vit.cfg.embed_dim

    @property
    def input_size(self) -> int:
        return self._input_size

    @property
    def backbone(self) -> str:
        return self._backbone

    @property
    def backbone_type(self) -> str:
        return self._backbone_type

    @property
    def vit_patch_size(self) -> int:
        return self._patch_size

    def _network_input(self, img: torch.Tensor) -> torch.Tensor:
        """The normalised ViT input: the frame itself when it is at network
        size and patch-aligned, else resized and centre-cropped."""
        H, W = img.shape[2], img.shape[3]
        ps = self._patch_size
        if not (min(H, W) == self._input_size and H % ps == 0 and W % ps == 0):
            img = center_crop(resize_smaller_edge_nearest(img, self._input_size), self._input_size)
        return imagenet_normalize(img)

    def calibrate(self, sample_batches) -> bool:
        """Record the static int8 activation scales from (B, 3, H, W) RGB
        frames in [0, 1], each preprocessed as `inference` does, in place.
        True when a calibration ran; False unless quant is "int8_static"."""
        if self._quant != "int8_static":
            return False
        frames = [torch.as_tensor(img, dtype=torch.float32, device=self.device) for img in sample_batches]
        calibrate_int8_static(self.vit, [self._network_input(img) for img in frames])
        return True

    @torch.no_grad()
    def inference(self, img: torch.Tensor) -> torch.Tensor:
        """img: (B, 3, H, W) RGB in [0, 1] -> dense features, upsampled to
        (H, H) for raw images (the reference's square) or to (H, W) for
        inputs already at network size (smaller edge == input_size)."""
        H, W = img.shape[2], img.shape[3]
        at_size = min(H, W) == self._input_size
        out = self.vit(self._network_input(img))
        hp, wp = out["grid"]
        feat = out["patch_tokens"].reshape(img.shape[0], hp, wp, -1).permute(0, 3, 1, 2)
        return interpolate_bilinear(feat, H, W if at_size else H)
