"""Model registry: `cfg["name"]` picks the class, `cfg["<snake>_cfg"]`
carries its kwargs (port of wild_visual_navigation_tpu/models/registry.py)."""

from __future__ import annotations

import re
from typing import Any, Mapping

from .simple_mlp import DoubleMLP, SimpleMLP

_MODELS = {"SimpleMLP": SimpleMLP, "DoubleMLP": DoubleMLP}
# Heads of the JAX package that this port does not have yet, with the
# ROADMAP.md item that brings them.
_NOT_PORTED = {"SimpleGCN": "Queue 1, item 22", "LinearRnvp": "Queue 1, item 22"}


def camel_to_snake(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return re.sub(r"_+", "_", s).lower()


def get_model(model_cfg: Mapping[str, Any], device=None, generator=None):
    """Instantiate the head named by model_cfg['name'] with the kwargs
    from model_cfg['<snake_name>_cfg'], on `device`, its weights drawn
    from `generator`."""
    name = model_cfg["name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported to torch yet (ROADMAP.md {_NOT_PORTED[name]})")
    if name not in _MODELS:
        raise ValueError(f"Model {name} not registered; have {sorted(_MODELS)}")
    kwargs = dict(model_cfg.get(f"{camel_to_snake(name)}_cfg", {}))
    return _MODELS[name](**kwargs, device=device, generator=generator)


def apply_model(model, x):
    """Row heads take (N, D) features and return (N, out)."""
    return model(x)
