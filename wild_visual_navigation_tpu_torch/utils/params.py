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

`resnet_state_from_jax` and `efficientnet_state_from_jax` convert the CNN pyramids
(models/resnet.py, models/efficientnet.py): a flax Conv kernel
(kh, kw, in, out) becomes the (out, in, kh, kw) weight, a depthwise one
(kh, kw, 1, C) the (C, 1, kh, kw) weight, and FrozenBatchNorm's
scale / bias / mean / var torchvision's weight / bias / running_mean /
running_var; the ResNet's `layer{s}_{b}` blocks become `layer{s}.{b}` and
their `downsample_conv` / `downsample_bn` `downsample.0` / `downsample.1`
(the inverse of tools/convert_dino_weights.py::convert_resnet_state_dict).

`stego_head_state_from_jax` converts the STEGO head (models/stego_head.py);
its ViT-B/8 backbone goes through `vit_state_from_jax` like any ViT.
`linear_rnvp_state_from_jax` and `simple_gcn_state_from_jax` convert the
anomaly flow and the graph head; `head_state_from_jax` picks the bridge
from the tree's layout.

`train_state_from_jax` carries a JAX estimator's whole optimisation
state (params, optax Adam moments, confidence state, step) into the
port's estimator.

The `*_to_jax` functions are the inverses (torch → JAX): they take the
port's state dicts (any device or float type; values widen to fp32) and
return nested dicts and tuples of numpy arrays in the flax tree's shape,
with the outer {"params": ...} that `model.init` returns. numpy out: a
JAX caller turns them into arrays (and `train_state_to_jax`'s optimiser
state into optax's tree) without this module importing JAX, flax or optax. A whole JAX runtime moves into a port runtime in two
calls: `WVNRuntime(backbone_params=vit_state_from_jax(backbone))`, then
`runtime.adopt_train_state(**train_state_from_jax(...))`, which also
publishes the head to inference. `load_head_npz` reads the converted head
written by tools/convert_head_to_torch.py.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .confidence_generator import ConfidenceState


def _inner(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(dst: dict, prefix: str, node: Mapping) -> None:
    # (in, out) -> (out, in); leading axes (a stack of heads) stay in front
    dst[f"{prefix}.weight"] = _t(np.swapaxes(np.asarray(node["kernel"]), -1, -2))
    dst[f"{prefix}.bias"] = _t(node["bias"])


def _norm(dst: dict, prefix: str, node: Mapping) -> None:
    dst[f"{prefix}.weight"] = _t(node["scale"])
    dst[f"{prefix}.bias"] = _t(node["bias"])


def vit_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax VisionTransformer params -> models/vit.py state_dict. A
    "quant_cal" collection beside "params" (a calibrated int8_static ViT)
    becomes the `amax` buffers of qkv, proj, fc1 and fc2; without one, a
    static ViT loads with zero `amax`, as JAX seeds the collection."""
    p = _inner(params)
    cal = params.get("quant_cal", {})
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
        for mod, layers in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
            for layer in layers:
                if f"block_{i}" in cal:
                    sd[f"{pre}.{mod}.{layer}.amax"] = _t(cal[f"block_{i}"][mod][layer]["amax"])
        i += 1
    return sd


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _cnn_state(node: Mapping, prefix: str, sd: dict, rename) -> None:
    """Walk a flax CNN tree: Conv kernels transposed to torch's layout, Conv
    biases kept, FrozenBatchNorm leaves renamed; `rename` maps a module's
    flax name to its torch path."""
    if "mean" in node and "var" in node:
        for src, dst in _BN_NAMES.items():
            sd[f"{prefix}.{dst}"] = _t(node[src])
        return
    if "kernel" in node:
        sd[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(node["bias"])
        return
    for name, child in node.items():
        _cnn_state(child, f"{prefix}.{rename(name)}" if prefix else rename(name), sd, rename)


def _resnet_name(name: str) -> str:
    if name == "downsample_conv":
        return "downsample.0"
    if name == "downsample_bn":
        return "downsample.1"
    if name.startswith("layer") and "_" in name:  # layer{s}_{b} -> layer{s}.{b}
        return name.replace("_", ".")
    return name


def resnet_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ResNetPyramid params -> models/resnet.py state_dict (torchvision's names)."""
    sd: dict[str, torch.Tensor] = {}
    _cnn_state(_inner(params), "", sd, _resnet_name)
    return sd


def efficientnet_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax EfficientNetPyramid params -> models/efficientnet.py state_dict
    (the flax tree's names)."""
    sd: dict[str, torch.Tensor] = {}
    _cnn_state(_inner(params), "", sd, lambda name: name)
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


# ------------------------------------------------------------ torch -> JAX
def _n(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _kernel_node(sd: Mapping, prefix: str) -> dict:
    """A Linear's weight (out, in) and bias -> flax Dense {kernel (in, out),
    bias}; leading axes (a stack of heads) stay in front."""
    return {"kernel": np.ascontiguousarray(np.swapaxes(_n(sd[f"{prefix}.weight"]), -1, -2)),
            "bias": _n(sd[f"{prefix}.bias"])}


def _indices(sd: Mapping, prefix: str) -> list[int]:
    """The sorted i of every `{prefix}.{i}.weight` in sd."""
    return sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in sd
                   if k.startswith(prefix + ".") and k.endswith(".weight")})


def _mlp_tree(sd: Mapping) -> dict:
    tree = {f"Dense_{i}": _kernel_node(sd, f"layers.{i}") for i in _indices(sd, "layers")}
    for tower in ("trav", "reco"):
        idx = _indices(sd, tower)
        for i in idx:
            tree[f"{tower}_out" if i == idx[-1] else f"{tower}_{i}"] = _kernel_node(sd, f"{tower}.{i}")
    if not tree:
        raise ValueError(f"no layers.i or trav./reco. Linears in a state dict with keys {sorted(sd)}")
    return tree


def mlp_state_to_jax(sd: Mapping) -> dict:
    """models/simple_mlp.py state_dict -> flax SimpleMLP ({"params":
    {Dense_i}}) or DoubleMLP (trav_i / trav_out, reco_i / reco_out)
    params: the inverse of mlp_state_from_jax."""
    return {"params": _mlp_tree(sd)}


def simple_gcn_state_to_jax(sd: Mapping) -> dict:
    """models/simple_gcn.py state_dict -> flax SimpleGCN params (Dense_i)."""
    return mlp_state_to_jax(sd)


def linear_rnvp_state_to_jax(sd: Mapping) -> dict:
    """models/linear_rnvp.py state_dict -> flax LinearRnvp params (layers_k
    / s_net, t_net / Dense_j): the inverse of linear_rnvp_state_from_jax."""
    tree: dict = {}
    for k in _indices(sd, "layers"):
        for net in ("s_net", "t_net"):
            prefix = f"layers.{k}.{net}."
            sub = {n[len(prefix):]: v for n, v in sd.items() if n.startswith(prefix)}
            if sub:
                tree.setdefault(f"layers_{k}", {})[net] = _mlp_tree(sub)
    if not tree:
        raise ValueError(f"no layers.k.s_net in a state dict with keys {sorted(sd)}")
    return {"params": tree}


def head_state_to_jax(sd: Mapping) -> dict:
    """Any head's state_dict -> its flax params: a LinearRnvp by its
    coupling nets, the others by their Linears."""
    return linear_rnvp_state_to_jax(sd) if any(".s_net." in k for k in sd) else mlp_state_to_jax(sd)


def vit_state_to_jax(sd: Mapping) -> dict:
    """models/vit.py state_dict -> flax VisionTransformer variables:
    {"params": ...}, and "quant_cal" beside it where the state holds the
    `amax` buffers of a static int8 ViT. The inverse of vit_state_from_jax."""
    p: dict = {}
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in sd:
            p[name] = _n(sd[name])
    p["patch_embed"] = {"kernel": np.ascontiguousarray(_n(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0)),
                        "bias": _n(sd["patch_embed.proj.bias"])}
    p["norm"] = {"scale": _n(sd["norm.weight"]), "bias": _n(sd["norm.bias"])}
    cal: dict = {}
    for i in _indices(sd, "blocks"):
        pre = f"blocks.{i}"
        blk = {f"norm{j}": {"scale": _n(sd[f"{pre}.norm{j}.weight"]), "bias": _n(sd[f"{pre}.norm{j}.bias"])}
               for j in (1, 2)}
        for mod, layers in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
            blk[mod] = {layer: _kernel_node(sd, f"{pre}.{mod}.{layer}") for layer in layers}
            for layer in layers:
                if f"{pre}.{mod}.{layer}.amax" in sd:
                    cal.setdefault(f"block_{i}", {}).setdefault(mod, {})[layer] = {
                        "amax": _n(sd[f"{pre}.{mod}.{layer}.amax"])}
        for ls in ("ls1", "ls2"):
            if f"{pre}.{ls}.gamma" in sd:
                blk[f"{ls}_gamma"] = _n(sd[f"{pre}.{ls}.gamma"])
        p[f"block_{i}"] = blk
    return {"params": p, "quant_cal": cal} if cal else {"params": p}


def confidence_state_to_jax(cg: ConfidenceState) -> dict:
    """The port's ConfidenceState -> JAX ConfidenceState fields as numpy
    (fp32, window_ptr int32): `ConfidenceState(**fields)` on the JAX side."""
    return {name: np.array(getattr(cg, name).detach().cpu().numpy(),
                           dtype=np.int32 if name == "window_ptr" else np.float32, copy=True)
            for name in ConfidenceState._fields}


class AdamState(NamedTuple):
    """optax.ScaleByAdamState's fields in their order: count (int32), mu
    and nu (trees of the params' layout)."""
    count: np.ndarray
    mu: dict
    nu: dict


def train_state_to_jax(params: Mapping, adam: Mapping | None, cg_state: ConfidenceState, step: int) -> tuple:
    """The port estimator's training state (TraversabilityEstimator.
    train_state(), the arguments of adopt_train_state) -> (params,
    opt_state, cg_state fields, step) of a JAX estimator: opt_state is
    optax.adam's (ScaleByAdamState, EmptyState()) as (AdamState, ()) with
    Adam's moments in the params' layout (None: fresh, zero moments at
    count 0). The inverse of train_state_from_jax."""
    tree = head_state_to_jax(params)
    if adam is None:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        adam = {"step": 0, "exp_avg": zeros, "exp_avg_sq": zeros}
    opt = AdamState(np.asarray(adam["step"], np.int32), head_state_to_jax(adam["exp_avg"]),
                    head_state_to_jax(adam["exp_avg_sq"]))
    return tree, (opt, ()), confidence_state_to_jax(cg_state), int(step)
