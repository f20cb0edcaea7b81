"""CNN feature-pyramid interface (ResNet and EfficientNet).

Port of wild_visual_navigation_tpu/feature_extractor/torchvision_interface.py:
nearest resize of the smaller edge, centre crop, ImageNet normalisation
and a frozen CNN trunk returning the multiscale level dict that the
multiscale pooling (ops/segment_ops.py::segment_pyramid_pool) consumes.
The models are the port's own modules (models/resnet.py,
models/efficientnet.py); nothing here imports the torchvision package.

Weights are drawn from `seed` (or `generator`) with flax's initialisers —
LeCun-normal kernels, identity BatchNorm — unless `params` (a state dict:
from utils/params.py::resnet_state_from_jax or efficientnet_state_from_jax,
or a torchvision ResNet checkpoint) is given: no checkpoint is in the
repository.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.efficientnet import efficientnet_pyramid_dim, make_efficientnet
from ..models.resnet import make_resnet, pyramid_feature_dim
from ..ops.resize import center_crop, imagenet_normalize, resize_smaller_edge_nearest
from ..utils.devices import torch_device


class TorchVisionInterface:
    def __init__(self, model_type: str = "resnet18", input_size: int = 448, params: Optional[dict] = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        self._input_size = input_size
        self._model_type = model_type
        self.device = torch_device(device, "TorchVisionInterface")
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        make = make_efficientnet if model_type.startswith("efficientnet") else make_resnet
        self.model = make(model_type, dtype=dtype, device=self.device, generator=generator)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval().requires_grad_(False)

    @property
    def params(self) -> dict:
        """The backbone's weights (the JAX interface's `params`), as a state dict."""
        return self.model.state_dict()

    @property
    def model_type(self) -> str:
        return self._model_type

    @property
    def input_size(self) -> int:
        return self._input_size

    @property
    def feature_dim(self) -> int:
        if self._model_type.startswith("efficientnet"):
            return efficientnet_pyramid_dim(self._model_type)
        return pyramid_feature_dim(self._model_type)

    @torch.no_grad()
    def inference(self, img: torch.Tensor) -> dict:
        """(B, 3, H, W) in [0, 1] -> {"layer1".."layer4": (B, C_i, H_i, W_i)} fp32."""
        x = center_crop(resize_smaller_edge_nearest(img, self._input_size), self._input_size)
        return self.model(imagenet_normalize(x))
