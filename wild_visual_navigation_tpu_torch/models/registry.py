"""Model registry: `cfg["name"]` picks the class, `cfg["<snake>_cfg"]`
carries its kwargs (port of wild_visual_navigation_tpu/models/registry.py)."""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch

from .linear_rnvp import LinearRnvp
from .simple_gcn import SimpleGCN
from .simple_mlp import DoubleMLP, SimpleMLP

_MODELS = {"SimpleMLP": SimpleMLP, "DoubleMLP": DoubleMLP, "SimpleGCN": SimpleGCN, "LinearRnvp": LinearRnvp}


def camel_to_snake(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return re.sub(r"_+", "_", s).lower()


def get_model(model_cfg: Mapping[str, Any], device=None, generator=None):
    """Instantiate the head named by model_cfg['name'] with the kwargs
    from model_cfg['<snake_name>_cfg'], on `device`, its weights drawn
    from `generator`."""
    name = model_cfg["name"]
    if name not in _MODELS:
        raise ValueError(f"Model {name} not registered; have {sorted(_MODELS)}")
    kwargs = dict(model_cfg.get(f"{camel_to_snake(name)}_cfg", {}))
    return _MODELS[name](**kwargs, device=device, generator=generator)


def model_needs_edges(model) -> bool:
    """Graph heads (SimpleGCN) take (x, edges, edge_valid); row heads
    (SimpleMLP, DoubleMLP, LinearRnvp) take x alone."""
    return isinstance(model, SimpleGCN)


def apply_model(model, x, edges=None, edge_valid=None):
    """Uniform call across row and graph heads. A graph head given no
    edges keeps only its self loops, a per-row head."""
    if model_needs_edges(model):
        if edges is None:
            edges = torch.zeros((2, 0), dtype=torch.int32, device=x.device)
            edge_valid = torch.zeros((0,), dtype=torch.bool, device=x.device)
        return model(x, edges, edge_valid)
    return model(x)
