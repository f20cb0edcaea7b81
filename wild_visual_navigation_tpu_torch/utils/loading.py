"""Config IO: YAML load/save and dataclass overlays.

A copy of wild_visual_navigation_tpu/utils/loading.py (yaml only): plain
YAML files applied onto nested dataclasses with dot-keyed overrides, and
the node parameters built from a stack of YAML profiles
(configs/default.yaml, configs/robots/*.yaml).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import yaml


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(data: Mapping, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dict(data), f)


def apply_overrides(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """Apply {possibly.dotted.key: value} overrides to a (nested)
    dataclass, returning a new instance. Unknown keys raise."""
    for key, value in overrides.items():
        parts = key.split(".")
        cfg = _set_path(cfg, parts, value)
    return cfg


def _set_path(cfg: Any, parts, value):
    name = parts[0]
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"cannot override field {name} on non-dataclass {type(cfg)}")
    if name not in {f.name for f in dataclasses.fields(cfg)}:
        raise KeyError(f"unknown config field: {name} on {type(cfg).__name__}")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{name: value})
    sub = getattr(cfg, name)
    return dataclasses.replace(cfg, **{name: _set_path(sub, parts[1:], value)})


def dataclass_from_yaml(cfg: Any, path: str) -> Any:
    """Overlay a YAML file of (nested or dotted) keys onto a dataclass."""
    data = load_yaml(path)
    flat = {}

    def _flatten(prefix, d):
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict) and _is_dataclass_path(cfg, key):
                _flatten(key, v)
            else:
                flat[key] = v

    _flatten("", data)
    return apply_overrides(cfg, flat)


def _is_dataclass_path(cfg: Any, dotted: str) -> bool:
    cur = cfg
    for name in dotted.split("."):
        if not dataclasses.is_dataclass(cur):
            return False
        try:
            cur = getattr(cur, name)
        except AttributeError:
            return False
    return dataclasses.is_dataclass(cur)


def load_node_params(*yaml_paths: str):
    """Build (FeatureExtractorNodeParams, LearningNodeParams) from a
    stack of YAML overlays — the reference's reload_rosparams.py flow
    (default.yaml + per-robot camera/robot profiles loaded onto the
    param server, then read key-by-key by each node). Later files win;
    each key is applied to every param class that has the field, and a
    key no class knows raises."""
    from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams

    fe = FeatureExtractorNodeParams()
    ln = LearningNodeParams()
    fe_fields = {f.name for f in dataclasses.fields(fe)}
    ln_fields = {f.name for f in dataclasses.fields(ln)}
    for path in yaml_paths:
        data = load_yaml(path)
        for key, value in data.items():
            known = False
            if key in fe_fields:
                fe = dataclasses.replace(fe, **{key: value})
                known = True
            if key in ln_fields:
                ln = dataclasses.replace(ln, **{key: value})
                known = True
            if not known:
                raise KeyError(f"{path}: unknown node param {key!r}")
    return fe, ln
