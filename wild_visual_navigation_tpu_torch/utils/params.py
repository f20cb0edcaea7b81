"""Weights carried across from the JAX package.

The JAX params arrive as nested dicts of numpy arrays (flax's layout,
with or without the outer {"params": ...}); these functions return the
port's state: `state_dict`s for `load_state_dict` and a ConfidenceState.
numpy in, torch out — nothing here imports JAX.

Layout changes:
  * flax `Dense` kernels are (in, out); `nn.Linear` weights are (out, in);
  * the flax `Conv` patch-embed kernel (ph, pw, 3, D) becomes the
    (D, 3, ph, pw) weight (the inverse of tools/convert_dino_weights.py);
  * the qkv columns keep flax's (3, heads, head_dim) order, which
    models/vit.py::Attention splits the same way.

`stego_head_state_from_jax` converts the STEGO head (models/stego_head.py);
its ViT-B/8 backbone goes through `vit_state_from_jax` like any ViT.
`linear_rnvp_state_from_jax` and `simple_gcn_state_from_jax` convert the
anomaly flow and the graph head; `head_state_from_jax` picks the bridge
from the tree's layout.

`train_state_from_jax` carries a JAX estimator's whole optimisation
state (params, optax Adam moments, confidence state, step) into the
port's estimator. A whole JAX runtime moves into a port runtime in two
calls: `WVNRuntime(backbone_params=vit_state_from_jax(backbone))`, then
`runtime.adopt_train_state(**train_state_from_jax(...))`, which also
publishes the head to inference. `load_head_npz` reads the converted head
written by tools/convert_head_to_torch.py.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .confidence_generator import ConfidenceState


def _inner(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(dst: dict, prefix: str, node: Mapping) -> None:
    dst[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    dst[f"{prefix}.bias"] = _t(node["bias"])


def _norm(dst: dict, prefix: str, node: Mapping) -> None:
    dst[f"{prefix}.weight"] = _t(node["scale"])
    dst[f"{prefix}.bias"] = _t(node["bias"])


def vit_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax VisionTransformer params -> models/vit.py state_dict."""
    p = _inner(params)
    sd: dict[str, torch.Tensor] = {}
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in p:
            sd[name] = _t(p[name])
    sd["patch_embed.proj.weight"] = _t(np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    _norm(sd, "norm", p["norm"])
    i = 0
    while f"block_{i}" in p:
        blk, pre = p[f"block_{i}"], f"blocks.{i}"
        _norm(sd, f"{pre}.norm1", blk["norm1"])
        _norm(sd, f"{pre}.norm2", blk["norm2"])
        _dense(sd, f"{pre}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.proj", blk["attn"]["proj"])
        _dense(sd, f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        for ls in ("ls1", "ls2"):
            if f"{ls}_gamma" in blk:
                sd[f"{pre}.{ls}.gamma"] = _t(blk[f"{ls}_gamma"])
        i += 1
    return sd


def stego_head_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax StegoHead params -> models/stego_head.py state_dict."""
    p = _inner(params)
    sd: dict[str, torch.Tensor] = {}
    for name in ("cluster1", "cluster2_fc1", "cluster2_fc2", "linear_probe"):
        _dense(sd, name, p[name])
    sd["cluster_probe"] = _t(p["cluster_probe"])
    return sd


def mlp_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax SimpleMLP (Dense_i) or DoubleMLP (trav_i / trav_out,
    reco_i / reco_out) params -> models/simple_mlp.py state_dict."""
    p = _inner(params)
    sd: dict[str, torch.Tensor] = {}
    dense = sorted((k for k in p if k.startswith("Dense_")), key=lambda k: int(k.split("_")[1]))
    for i, k in enumerate(dense):
        _dense(sd, f"layers.{i}", p[k])
    for tower in ("trav", "reco"):
        mids = sorted((k for k in p if k.startswith(f"{tower}_") and k != f"{tower}_out"),
                      key=lambda k: int(k.split("_")[1]))
        if f"{tower}_out" in p:
            for i, k in enumerate(mids + [f"{tower}_out"]):
                _dense(sd, f"{tower}.{i}", p[k])
    if not sd:
        raise ValueError(f"no Dense_i or trav_/reco_ layers in params with keys {sorted(p)}")
    return sd


def simple_gcn_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax SimpleGCN params (Dense_i) -> models/simple_gcn.py state_dict:
    its layers are `layers.i`, as SimpleMLP's."""
    return mlp_state_from_jax(params)


def linear_rnvp_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax LinearRnvp params (layers_k / s_net, t_net / Dense_j) ->
    models/linear_rnvp.py state_dict (layers.k.s_net.layers.j, ...)."""
    p = _inner(params)
    sd: dict[str, torch.Tensor] = {}
    k = 0
    while f"layers_{k}" in p:
        for net in ("s_net", "t_net"):
            if net in p[f"layers_{k}"]:
                for name, value in mlp_state_from_jax(p[f"layers_{k}"][net]).items():
                    sd[f"layers.{k}.{net}.{name}"] = value
        k += 1
    if not sd:
        raise ValueError(f"no layers_k in params with keys {sorted(p)}")
    return sd


def head_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Any head's flax params -> its state_dict: LinearRnvp by its
    layers_k, the others (SimpleMLP, DoubleMLP, SimpleGCN) by their Dense
    layers."""
    return linear_rnvp_state_from_jax(params) if "layers_0" in _inner(params) else mlp_state_from_jax(params)


def confidence_state_from_jax(cg: Mapping, device=None) -> ConfidenceState:
    """JAX ConfidenceState fields (a dict or the NamedTuple's _asdict())
    -> the port's ConfidenceState."""
    if hasattr(cg, "_asdict"):
        cg = cg._asdict()
    fields = {}
    for name in ConfidenceState._fields:
        a = np.asarray(cg[name])
        dtype = torch.int32 if name == "window_ptr" else torch.float32
        fields[name] = torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)
    return ConfidenceState(**fields)


def load_head_npz(path) -> tuple[dict, dict, int]:
    """Read a converted head: ({"params": {Dense_i: {kernel, bias}}},
    cg_state fields, step), all numpy."""
    params: dict = {}
    cg: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            top, _, rest = key.partition("/")
            if top == "cg_state":
                cg[rest] = z[key]
            elif top == "params":
                layer, leaf = rest.split("/")
                params.setdefault(layer, {})[leaf] = z[key]
        step = int(z["step"])
    return {"params": params}, cg, step


def train_state_from_jax(params: Mapping, opt_state, cg_state, step: int, device=None) -> dict:
    """A JAX estimator's numpy training state -> keyword arguments of the
    port's `TraversabilityEstimator.adopt_train_state`, for any head.

    opt_state is `optax.adam`'s state (a tuple holding a ScaleByAdamState,
    or that state itself); its `mu` / `nu` trees have the params' layout
    and become torch.optim.Adam's `exp_avg` / `exp_avg_sq` with the same
    kernel transposes as the params, and its `count` Adam's `step`."""
    adam = opt_state if hasattr(opt_state, "mu") else next(s for s in opt_state if hasattr(s, "mu"))
    return {
        "params": head_state_from_jax(params),
        "adam": {
            "step": int(np.asarray(adam.count)),
            "exp_avg": head_state_from_jax(adam.mu),
            "exp_avg_sq": head_state_from_jax(adam.nu),
        },
        "cg_state": confidence_state_from_jax(cg_state, device),
        "step": int(step),
    }
