"""Device-mesh parallelism: sharding rules and the multi-rank train and
inference steps, on torch.distributed.

Port of wild_visual_navigation_tpu/parallel/mesh.py. The mesh has the same
axes, ("dp", "tp"): data parallel over frames and batch rows, tensor
parallel over the backbone's attention heads and MLP hidden units and over
the head's linear layers. What differs is who drives it. A JAX mesh is one
process driving N devices, and XLA inserts the collectives from the
shardings. A torch mesh spans processes, one per rank: every rank runs the
same program on its share (SPMD), and the collectives are explicit:

  * the gradient sum over "dp" is one `all_reduce` per parameter after the
    backward pass (`dp_train_step`); every sum, count, minimum
    and maximum the loss takes over the batch is reduced over the same
    group first (utils/loss.py, utils/confidence_generator.py), so the
    ranks' losses add up to the loss of the whole batch;
  * the head's linear layers are split over "tp" with PyTorch's own
    `parallelize_module` (`ColwiseParallel` / `RowwiseParallel`, as
    `mlp_param_spec` places them);
  * the ViT is split over "tp" by head (models/vit.py::shard_heads_), not by
    `parallelize_module`: its linears call `F.linear` on the weight and
    bypass module hooks, and a contiguous split of the fused qkv rows would
    give the first rank all of q and half of k. JAX's P(None, "tp") on qkv
    makes the same contiguous cut and GSPMD reshuffles it; the port takes
    each rank's whole heads, a permutation of the same numbers, so kernel
    K1 runs on each rank's heads with no collective inside attention. A
    ViT whose head count tp does not divide keeps attention replicated
    (ViT-S's 6 heads at tp = 4), where JAX's spec would still split it;
  * gathers (`all_gather_rows`) are one `all_gather_into_tensor` on either
    backend: Gloo gathers tensors on the card as well as on the CPU, so
    several ranks can share one card (NCCL refuses two ranks on a device).

Placements follow torch's layouts: `nn.Linear.weight` is (out, in) where
flax's kernel is (in, out), so JAX's P(None, "tp") on a kernel is Shard(0)
on the weight, P("tp", None) is Shard(1), and a column-split layer's bias
is Shard(0).
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.confidence_generator import group_reduce

__all__ = [
    "all_gather_rows",
    "create_mesh",
    "dp_split",
    "dp_train_step",
    "local_rows",
    "make_multichip_inference",
    "make_multichip_train_step",
    "mesh_axis",
    "mlp_param_spec",
    "reduce_gradients",
    "shard_module",
    "vit_param_spec",
]


def create_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: Optional[int] = None,
                device: str = "cuda") -> DeviceMesh:
    """2-D ("dp", "tp") mesh over the ranks of the default process group.
    Default: every rank on dp (pure data parallel) unless tp is given.

    A torch mesh spans processes, not the devices of one process, so
    `n_devices` is the world size: any other value raises. `device` is the
    mesh's device type ("cuda", or "cpu" where the caller asks for it)."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a torch mesh spans the ranks of the process group: n_devices must be the world size "
                         f"{world}, got {n}")
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != n({n})"
    return init_device_mesh(device, (dp, tp), mesh_dim_names=("dp", "tp"))


def mesh_axis(mesh: Optional[DeviceMesh], name: str):
    """(size, this rank's index, process group) of one mesh axis; (1, 0,
    None) when there is no mesh or it lacks the axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name), mesh.get_group(name)


# ------------------------------------------------------------- collectives
def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's equal-shaped `x`, concatenated along dim 0 in
    group-rank order. Booleans travel as uint8."""
    if dist.get_world_size(group) == 1:
        return x
    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.bool() if x.dtype == torch.bool else out


def local_rows(x: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Part `index` of x's rows cut into `parts` equal parts, x padded with
    zero rows (False for booleans) to a multiple of `parts` first."""
    per = -(-x.shape[0] // parts)
    if per * parts != x.shape[0]:
        x = torch.cat([x, x.new_zeros((per * parts - x.shape[0], *x.shape[1:]))])
    return x[index * per:(index + 1) * per]


def dp_split(mesh: Optional[DeviceMesh], fn: Callable, x: torch.Tensor):
    """fn on this dp rank's rows of `x`, the results gathered over dp.

    A leading size the dp degree does not divide is padded with zero rows
    up to a multiple of it, and the padding is dropped from the gathered
    results, as GSPMD pads. fn returns a tensor or a tuple (NamedTuple) of
    tensors with the rows on dim 0."""
    dp, r, group = mesh_axis(mesh, "dp")
    if dp == 1:
        return fn(x)
    B = x.shape[0]
    out = fn(local_rows(x, dp, r))
    if isinstance(out, torch.Tensor):
        return all_gather_rows(out, group)[:B]
    parts = [all_gather_rows(t, group)[:B] for t in out]
    return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)


# ------------------------------------------------------------ param specs
_HEAD_LAYER = re.compile(r"^(?:layers|trav|reco)\.(\d+)\.(weight|bias)$")
_VIT_LAYER = re.compile(r"^blocks\.\d+\.(?:attn|mlp)\.(qkv|proj|fc1|fc2)\.(weight|bias)$")


def mlp_param_spec(model: torch.nn.Module, tp: int = 2) -> dict:
    """{state-dict name: Placement} for an MLP head (SimpleMLP, DoubleMLP's
    towers, SimpleGCN): Megatron column/row split alternating across the
    linear layers. Layer 2k: weight (hid, in) Shard(0), bias Shard(0);
    layer 2k+1: weight (out, hid) Shard(1), bias replicated. Dimensions
    that tp does not divide stay replicated."""
    spec = {}
    for name, p in model.named_parameters():
        m = _HEAD_LAYER.match(name)
        spec[name] = Replicate()
        if m is None:
            continue
        col_split = int(m.group(1)) % 2 == 0
        if m.group(2) == "weight" and p.dim() == 2:
            if col_split and p.shape[0] % tp == 0:
                spec[name] = Shard(0)
            elif not col_split and p.shape[1] % tp == 0:
                spec[name] = Shard(1)
        elif m.group(2) == "bias" and col_split and p.shape[0] % tp == 0:
            spec[name] = Shard(0)
    return spec


def vit_param_spec(model: torch.nn.Module, tp: int = 2) -> dict:
    """{state-dict name: Placement} for the ViT: attention qkv and MLP fc1
    column-split (weight and bias Shard(0)), proj and fc2 row-split (weight
    Shard(1), bias replicated, added once after the sum). Attention is
    split only where tp divides the head count, the MLP where it divides
    the hidden width."""
    heads_split = model.cfg.num_heads % tp == 0
    spec = {}
    for name, p in model.named_parameters():
        spec[name] = Replicate()
        m = _VIT_LAYER.match(name)
        if m is None or (m.group(1) in ("qkv", "proj") and not heads_split):
            continue
        if m.group(1) in ("qkv", "fc1") and p.shape[0] % tp == 0:
            spec[name] = Shard(0)
        elif m.group(1) in ("proj", "fc2") and m.group(2) == "weight" and p.shape[1] % tp == 0:
            spec[name] = Shard(1)
    return spec


def shard_module(model: torch.nn.Module, spec: dict, mesh: DeviceMesh) -> torch.nn.Module:
    """Place the model's parameters over the mesh's "tp" axis as `spec`
    says, in place, and return it.

    A VisionTransformer keeps each rank's slices as plain tensors
    (models/vit.py::shard_heads_). A head's linear layers become DTensors
    through `parallelize_module`: a Shard(0) layer is ColwiseParallel, a
    Shard(1) layer RowwiseParallel (a column-split layer with no row-split
    successor gathers its output). Every rank holds the full weights
    before, as every rank builds the model from the same seed, so the
    slices are cut locally with no scatter."""
    from ..models.vit import VisionTransformer, shard_heads_

    tp, rank, group = mesh_axis(mesh, "tp")
    if tp == 1:
        return model
    if isinstance(model, VisionTransformer):
        return shard_heads_(model, group, rank, tp, spec)
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    layers = sorted({n.rsplit(".", 1)[0] for n, pl in spec.items() if isinstance(pl, Shard) and n.endswith("weight")},
                    key=lambda n: (n.split(".")[0], int(n.split(".")[1])))
    plan = {}
    for name in layers:
        if spec[f"{name}.weight"] == Shard(1):
            plan[name] = RowwiseParallel()
        else:
            prefix, i = name.rsplit(".", 1)
            partner = spec.get(f"{prefix}.{int(i) + 1}.weight")
            plan[name] = ColwiseParallel() if partner == Shard(1) else ColwiseParallel(output_layouts=Replicate())
        plan[name].src_data_rank = None  # every rank holds the same weights: slice, do not scatter
    parallelize_module(model, mesh["tp"], plan)
    return model


# ------------------------------------------------------ multi-rank steps
def reduce_gradients(model: torch.nn.Module, group) -> None:
    """Sum every parameter's gradient over `group` (a DTensor's local shard
    in place)."""
    if group is None or dist.get_world_size(group) == 1:
        return
    for p in model.parameters():
        if p.grad is not None:
            g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
            dist.all_reduce(g, group=group)


def dp_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable, group):
    """One data-parallel optimisation step: loss_fn() -> (loss, aux,
    cg_state2) on this rank's rows of the batch, with its batch reductions
    over `group` (the dp process group, or None) -> autograd -> gradients
    summed over `group` -> optimizer step. Returns (the whole batch's loss,
    aux's scalars (all but the per-sample "confidence"), likewise summed
    over the ranks' parts, cg_state2). The one step of
    `make_multichip_train_step`, the estimator's train step and
    parallel/distributed.py::DistributedTrainer."""
    optimizer.zero_grad(set_to_none=True)
    loss, aux, cg2 = loss_fn()
    loss.backward()
    reduce_gradients(model, group)
    optimizer.step()
    keys = [k for k in aux if k != "confidence"]
    out = group_reduce(torch.stack([loss.detach()] + [aux[k].detach() for k in keys]), group)
    return out[0], dict(zip(keys, out[1:])), cg2


def make_multichip_train_step(mesh: DeviceMesh, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                              loss_fn: Callable):
    """The dp x tp train step: returns (train_step, place_batch).

    loss_fn(model, batch, cg_state, group) -> (loss, (aux, cg_state2)),
    where `group` is the dp process group its batch reductions run over,
    `loss` this rank's part of the whole batch's loss and aux a dict of
    scalar parts likewise (a per-sample "confidence" aside).
    place_batch(batch) takes this rank's dp rows of a tuple of tensors
    whose leading axis dp divides. train_step(cg_state, batch) runs
    `dp_train_step` on them and returns (loss of the whole batch, aux,
    cg_state2). The model is placed over tp beforehand (shard_module)."""
    dp, r, group = mesh_axis(mesh, "dp")

    def place_batch(batch):
        def rows(x):
            if x.shape[0] % dp:
                raise ValueError(f"the batch's {x.shape[0]} rows do not split over dp = {dp}")
            n = x.shape[0] // dp
            return x[r * n:(r + 1) * n]

        if not isinstance(batch, tuple):
            return rows(batch)
        parts = [rows(x) for x in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else tuple(parts)

    def train_step(cg_state, batch):
        def loss():
            value, (aux, cg2) = loss_fn(model, batch, cg_state, group)
            return value, aux, cg2

        return dp_train_step(model, optimizer, loss, group)

    return train_step, place_batch


def make_multichip_inference(mesh: DeviceMesh, apply_fn: Callable) -> Callable:
    """Batched inference split over dp: infer(imgs) runs apply_fn on this
    rank's frames and gathers the outputs, so every rank holds all of
    them. apply_fn(imgs) -> a tensor or a tuple of tensors, frames first."""

    def infer(imgs):
        return dp_split(mesh, apply_fn, imgs)

    return infer
