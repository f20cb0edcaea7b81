"""Multi-process deployment: one process per camera group.

Port of wild_visual_navigation_tpu/parallel/distributed.py on
torch.distributed:

  * each process runs its own runtime and estimator for ingestion (feature
    extraction, graph bookkeeping, supervision reprojection) on its own
    device: per-camera-group work needs no cross-process traffic;
  * the train step is global and data parallel: every process samples its
    own rows with its estimator's cadence, and the processes together run
    the estimator's step (`TraversabilityEstimator.step_on_batch`) on the
    concatenation of all their rows: the loss's counts and statistics are
    reduced over the processes, the gradients summed, and Adam steps the
    same replicated params on every process. A process with no trainable
    data contributes fully-masked rows, so it never deadlocks the others;
  * at the hot-swap cadence each process writes the params back into its
    own estimator (`sync_to_estimator`) for inference and checkpoints.

With tp > 1 the mesh is ("dp", "tp"): the processes of a tp group pool
their rows (gathered over tp), and the head's linear layers are split over
tp with `parallelize_module` (parallel/mesh.py::shard_module, following
`mlp_param_spec`); the gradients are summed over dp.

There is no coordinator service as in jax.distributed: `initialize_process`
gives `init_process_group` the address, the world size and the rank.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from ..models.registry import model_needs_edges
from ..utils.confidence_generator import ConfidenceState
from ..utils.data import TravBatch, batch_from_arrays
from .mesh import all_gather_rows, mesh_axis, mlp_param_spec, shard_module


def initialize_process(coordinator_address: str, num_processes: int, process_id: int,
                       backend: Optional[str] = None) -> None:
    """`dist.init_process_group` for rank `process_id` of `num_processes`.
    `coordinator_address` is "host:port" (tcp) or a full init URL
    ("tcp://...", "file://..."). `backend` defaults to NCCL, the card's;
    on the CPU, or for several ranks sharing one card (NCCL refuses two
    ranks on a device), pass "gloo". JAX's `cpu_devices` has no
    counterpart: a rank is a process, not a device."""
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if torch.cuda.is_available():  # this process's card: its rank on the host, modulo the host's cards
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)) % torch.cuda.device_count())
    dist.init_process_group(backend or "nccl", init_method=init, world_size=num_processes, rank=process_id)


def create_global_mesh(tp: int = 1, device: str = "cuda") -> DeviceMesh:
    """Mesh over every process of the default group: ("dp",) for tp == 1
    (the trainer's batch axis; replicated params), else ("dp", "tp") with
    the head's linear layers Megatron-split over tp. tp must divide the
    ranks of one host (LOCAL_WORLD_SIZE, the world size when unset), so a
    tp group never straddles hosts."""
    n = dist.get_world_size()
    if tp <= 1:
        return init_device_mesh(device, (n,), mesh_dim_names=("dp",))
    assert n % tp == 0, f"tp={tp} must divide the world size {n}"
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    assert n_local % tp == 0, (f"tp={tp} must divide the per-host process count {n_local} "
                               "(tp groups must not straddle hosts)")
    return init_device_mesh(device, (n // tp, tp), mesh_dim_names=("dp", "tp"))


def _full(t: torch.Tensor, group) -> torch.Tensor:
    """A DTensor's full value (its shards gathered over `group`, the tp
    group its single mesh axis spans); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t.detach()
    local = t.to_local().detach()
    dim = t.placements[0].dim if t.placements[0].is_shard() else None
    if dim is None:
        return local
    return all_gather_rows(local.movedim(dim, 0), group).movedim(0, dim)


class DistributedTrainer:
    """Global data-parallel trainer over per-process estimators.

    `step()` and `sync_to_estimator()` are collective: every process calls
    them at the same point of its loop. `step()` is safe on a process with
    no trainable data yet: it contributes fully-masked rows, which the
    masked reductions ignore."""

    def __init__(self, estimator, mesh: Optional[DeviceMesh] = None, tp: int = 1):
        from ..traversability.estimator import adam_with_moments  # the estimator imports this package

        est = estimator
        self._est = est
        self._mesh = mesh or create_global_mesh(tp, device=est._device.type)
        self._tp, self._tp_rank, self._tp_group = mesh_axis(self._mesh, "tp")
        _, _, self._dp_group = mesh_axis(self._mesh, "dp")
        # the training copy of the head: all processes start from the same
        # seed, so the copies are identical; a loaded checkpoint must be
        # loaded by every process before this
        self._model = copy.deepcopy(est.model)
        adam = _adam_state(est.model, est.optimizer)
        if self._tp > 1:
            self._spec = mlp_param_spec(self._model, tp=self._tp)
            shard_module(self._model, self._spec, self._mesh)
            if adam is not None:
                adam = {**adam, **{k: {n: self._shard(n, m) for n, m in adam[k].items()}
                                   for k in ("exp_avg", "exp_avg_sq")}}
        self._optimizer = adam_with_moments(self._model, est._lr, adam)
        self._cg_state = ConfidenceState(*(t.clone() for t in est.confidence_state))
        self._step = est.step

    def _shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full tensor placed like parameter `name`
        (Adam's moments are DTensors like their parameters)."""
        p = dict(self._model.named_parameters())[name]
        if not isinstance(p, DTensor):
            return full
        pl = p.placements[0]
        local = full.tensor_split(self._tp, dim=pl.dim)[self._tp_rank] if pl.is_shard() else full
        return DTensor.from_local(local.contiguous(), p.device_mesh, p.placements, run_check=False)

    @property
    def step_count(self) -> int:
        return self._step

    @property
    def mesh(self) -> DeviceMesh:
        return self._mesh

    def _local_batch(self) -> TravBatch:
        """This process's rows: (rows, D) features, (rows,) labels, label
        and sample validity, and each node's adjacency for a graph head;
        all masked when no local data is trainable yet."""
        est = self._est
        # the estimator's amortised resolve cadence: the readback of pending
        # supervision waits for the device, so it runs every
        # supervision_resolve_every steps, or while too few nodes are valid
        est._train_calls += 1
        if (est._train_calls % est._resolve_every == 0
                or est._mission_graph.get_num_valid_nodes() <= est._min_samples_for_training):
            est._resolve_pending_supervision()
        idx = est._sample_indices()
        ready = idx is not None and est._mission_graph.get_num_valid_nodes() > est._min_samples_for_training
        if ready:
            with est.lock:
                return est._batch(idx, split=False)
        return masked_batch(est)

    def step(self) -> dict:
        """One collective optimisation step on every process's rows."""
        batch = self._local_batch()
        if self._tp > 1:  # the tp group's processes train on their pooled rows
            batch = TravBatch(*(None if t is None else all_gather_rows(t, self._tp_group) for t in batch))
        loss, aux, self._cg_state = self._est.step_on_batch(self._model, self._optimizer, self._cg_state, batch,
                                                            self._dp_group)
        self._step += 1
        return {"loss_total": float(loss), "step": self._step, **{k: float(v) for k, v in aux.items()}}

    def sync_to_estimator(self) -> None:
        """Write the full params, Adam moments and confidence state back
        into the local estimator (the hot-swap and checkpoint surface).
        Collective when tp > 1: the shards are gathered over tp."""
        params = {n: _full(p, self._tp_group) for n, p in self._model.named_parameters()}
        adam = _adam_state(self._model, self._optimizer, lambda t: _full(t, self._tp_group))
        self._est.adopt_train_state(params, adam, self._cg_state, step=self._step)


def masked_batch(est) -> TravBatch:
    """A batch of the estimator's shape with every row masked: what a
    process with no trainable data contributes."""
    dev, B, S, D = est._device, est._batch_size, est._S, est._D
    batch = batch_from_arrays(torch.zeros((B, S, D), device=dev), torch.zeros((B, S), device=dev),
                              torch.zeros((B, S), dtype=torch.bool, device=dev),
                              torch.zeros((B, S), dtype=torch.bool, device=dev))
    if model_needs_edges(est.model):
        E = est._max_edges
        batch = batch._replace(edges=torch.zeros((B, 2, E), dtype=torch.int32, device=dev),
                               edge_valid=torch.zeros((B, E), dtype=torch.bool, device=dev))
    return batch


def _adam_state(model: torch.nn.Module, opt: torch.optim.Optimizer, full=lambda t: t.detach()) -> Optional[dict]:
    """The optimizer's state as `adam_with_moments` takes it: {"step",
    "exp_avg", "exp_avg_sq"} with the moments by parameter name (each
    through `full`); None before the first step."""
    named = [(n, p) for n, p in model.named_parameters() if p in opt.state]
    if not named:
        return None
    return {"step": int(opt.state[named[0][1]]["step"]),
            "exp_avg": {n: full(opt.state[p]["exp_avg"]) for n, p in named},
            "exp_avg_sq": {n: full(opt.state[p]["exp_avg_sq"]) for n, p in named}}

