"""TraversabilityEstimator: the online self-supervised learning engine.

Port of wild_visual_navigation_tpu/traversability/estimator.py. Two
device paths, driven by host-side graph bookkeeping:

  * `_reproject_update`, the supervision hot path: for a fixed fan-out of
    B_max in-range mission nodes, project the footprint polygon with each
    node's camera, fill its convex hull (kernel K4 on the card), fuse
    pessimistically (min with the +inf-sentinel mask) and recompute the
    per-segment supervision signals. Queued footprint updates are applied
    one after another in `flush_supervision`, which keeps the sequential
    min-fusion of separate updates.
  * the train step: gather a sampled batch from the mission buffer,
    confidence-weighted loss (or, in anomaly mode, the LinearRnvp flow's
    negative log-likelihood over the supervised segments), autograd
    through the head, Adam (the formula of `optax.adam`), and the
    confidence-state update. A graph head (SimpleGCN) gets each node's
    segment adjacency, recomputed from the stored segmentation, and the
    batch's graphs run as one graph (models/simple_gcn.py::batch_graph).

Mission and supervision graphs gate node insertion by SE(3) distance and
answer radius queries on the host (numpy); the ring buffer
(mission_buffer.py) holds the padded training state on the device.

Under a ("dp", "tp") mesh (parallel/mesh.py) every rank runs the same
estimator on the same inputs (SPMD) and keeps the same state: the fan-out
of a footprint update is split over dp, each rank fills its rows and the
rows are gathered back; the train step takes each dp rank's nodes of the
sampled batch, reduces the loss's counts and statistics over dp, and sums
the gradients over dp before Adam. The head stays replicated.

Checkpoints: the hot-swap dict (a snapshot of params + confidence
statistics), full mission checkpoints in torch's own format, the per-node
dataset export, and the whole object as a pickle (`save_pickle` /
`load_pickle`): its tensors travel on the CPU and are put back on the
saved device, or on the one `load_pickle` names.
"""

from __future__ import annotations

import copy
import os
import pickle
import threading
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..models.registry import apply_model, get_model, model_needs_edges
from ..models.simple_gcn import batch_graph
from ..ops.projection import Camera
from ..ops.rasterize import project_and_render
from ..ops.segment_ops import adjacency_list, segment_masked_mean
from ..parallel.mesh import all_gather_rows, dp_train_step, mesh_axis
from ..utils.confidence_generator import (
    ConfidenceConfig,
    ConfidenceState,
    confidence_init,
    confidence_load_state_dict,
    confidence_state_dict,
)
from ..utils.data import TravBatch, batch_from_arrays
from ..utils.locks import TrackedRLock
from ..utils.loss import AnomalyLossConfig, TraversabilityLossConfig, anomaly_loss, traversability_loss
from ..utils.operation_modes import WVNMode
from .graphs import BaseGraph, DistanceWindowGraph, MaxElementsGraph
from .mission_buffer import MissionBuffer, buffer_init, buffer_insert
from .nodes import MissionNode, SupervisionNode

_MAX_FOOTPRINT_POINTS = 64  # static pad for footprint polygons


# the device `load_pickle` asks for, read by __setstate__ (None: the saved one)
_unpickle_device = threading.local()


def _node_owns_slot(node) -> bool:
    """Mission nodes still holding a ring-buffer slot are spared from the
    graph's FIFO eviction."""
    return getattr(node, "buffer_slot", -1) >= 0


def make_adam(params, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root (eps_root 0), bias-corrected moments. A head split over tp
    mixes DTensor and plain parameters, which Adam's multi-tensor path
    cannot group: it steps them one by one."""
    params = list(params)
    foreach = False if any(isinstance(p, DTensor) for p in params) else None
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=foreach)


def adam_with_moments(model: torch.nn.Module, lr: float, adam: Optional[dict]) -> torch.optim.Adam:
    """`make_adam` over the model's parameters, holding the given moments:
    adam is {"step", "exp_avg", "exp_avg_sq"} with the moments by
    parameter name (None: fresh moments)."""
    opt = make_adam(model.parameters(), lr)
    if adam is not None:
        for name, p in model.named_parameters():
            opt.state[p] = {
                "step": torch.tensor(float(adam["step"])),
                "exp_avg": adam["exp_avg"][name].to(p.device, torch.float32).clone(),
                "exp_avg_sq": adam["exp_avg_sq"][name].to(p.device, torch.float32).clone(),
            }
    return opt


class TraversabilityEstimator:
    def __init__(
        self,
        model_cfg: dict,
        loss_cfg: Optional[TraversabilityLossConfig] = None,
        anomaly_loss_cfg: Optional[AnomalyLossConfig] = None,
        lr: float = 1e-3,
        max_distance: float = 3.0,
        image_distance_thr: float = 0.2,
        supervision_distance_thr: float = 0.1,
        min_samples_for_training: int = 5,
        batch_size: int = 8,
        mode: WVNMode = WVNMode.ONLINE,
        extraction_store_folder: Optional[str] = None,
        anomaly_detection: bool = False,
        buffer_capacity: int = 256,
        num_segments: int = 100,
        feature_dim: int = 384,
        image_height: int = 224,
        image_width: int = 224,
        max_edges: int = 1024,
        reprojection_fanout: int = 32,
        seed: int = 42,
        sampling_seed: Optional[int] = None,
        vis_node_index: int = 10,
        log_confidence_folder: Optional[str] = None,
        log_every: int = 20,
        supervision_flush_every: int = 1,
        supervision_resolve_every: int = 1,
        graph_max_elements_factor: int = 4,
        mesh=None,
        device="cuda",
    ):
        """The JAX estimator's arguments, plus `device` (the card unless the
        caller asks for the CPU), and `sampling_seed`. `mesh` is a
        ("dp", "tp") DeviceMesh (parallel/mesh.py::create_mesh): the
        reprojection fan-out and the train step's nodes split over dp, and
        every rank must make the same calls with the same inputs. `seed`
        draws the head's weights. `sampling_seed` (`seed` when None) seeds
        the estimator's own `np.random.RandomState` for batch sampling,
        which draws what the JAX package's global `np.random.choice` draws
        after `np.random.seed(sampling_seed)`: a JAX run whose head key and
        global seed differ replays with the head carried over and its
        global seed here.

        graph_max_elements_factor: the ONLINE mission graph keeps at most
        `factor * buffer_capacity` host nodes (0 = unbounded, the
        reference's behaviour); slot-holding nodes are never evicted.
        max_edges is the per-node adjacency capacity of graph heads.
        anomaly_detection trains a LinearRnvp head (`model_cfg`) with
        `anomaly_loss_cfg`."""
        self._device = torch.device(device)
        self._mesh = mesh
        self._dp, self._dp_rank, self._dp_group = mesh_axis(mesh, "dp")
        self._mode = mode
        self._extraction_store_folder = extraction_store_folder
        self._min_samples_for_training = min_samples_for_training
        self._batch_size = batch_size
        self._anomaly_detection = anomaly_detection
        self._H, self._W = image_height, image_width
        self._S, self._D = num_segments, feature_dim
        self._max_edges = max_edges  # graph heads only
        self._B_max = reprojection_fanout
        self._vis_node_index = vis_node_index
        self._vis_mission_node = None

        self._supervision_graph = DistanceWindowGraph(max_distance=max_distance, edge_distance=supervision_distance_thr)
        if mode == WVNMode.EXTRACT_LABELS:
            self._mission_graph: BaseGraph = MaxElementsGraph(edge_distance=image_distance_thr,
                                                              max_elements=buffer_capacity)
        else:
            self._mission_graph = MaxElementsGraph(edge_distance=image_distance_thr,
                                                   max_elements=graph_max_elements_factor * buffer_capacity,
                                                   keep_fn=_node_owns_slot)

        self._buffer = buffer_init(buffer_capacity, num_segments, feature_dim, image_height, image_width,
                                   device=self._device)
        self._next_slot = 0
        self._slot_to_node: dict[int, MissionNode] = {}

        self._model = get_model(model_cfg, device=self._device, generator=torch.Generator().manual_seed(seed))
        if anomaly_detection:
            self._loss_cfg = anomaly_loss_cfg or AnomalyLossConfig()
        else:
            self._loss_cfg = loss_cfg or TraversabilityLossConfig()
        self._cg_cfg: ConfidenceConfig = self._loss_cfg.confidence
        self._lr = lr
        self._optimizer = make_adam(self._model.parameters(), lr)
        self._cg_state = confidence_init(self._device)
        self._step = 0
        self._loss = float("inf")
        self._rng = np.random.RandomState(seed if sampling_seed is None else sampling_seed)

        # one re-entrant lock serialises every mission-buffer read and write
        self._lock = TrackedRLock()
        self._pause_training = False
        self._pause_mission_graph = False
        self._pause_supervision_graph = False
        # (mission nodes, device counts) awaiting validity resolution
        self._pending_supervision: list = []
        self._log_confidence_folder = log_confidence_folder
        self._log_every = log_every
        # queued footprint updates, applied in order at each flush
        self._flush_every = max(1, supervision_flush_every)
        self._pending_footprints: list = []
        # validity flags are read back (one device-to-host copy that waits
        # for the stream) only every N train calls, and whenever too few
        # nodes are known to be valid
        self._resolve_every = max(1, supervision_resolve_every)
        self._train_calls = 0

    # ------------------------------------------------------ supervision
    def flush_supervision(self):
        """Apply every queued footprint update, in queue order."""
        with self._lock:
            if not self._pending_footprints:
                return
            pending, self._pending_footprints = self._pending_footprints, []
            for idx, footprint, trav, nodes in pending:
                self._pending_supervision.append((nodes, self._reproject_update(idx, footprint, trav)))
        # bound the queue while learning is paused (nothing else resolves)
        if len(self._pending_supervision) >= 64:
            self._resolve_pending_supervision()

    def _resolve_pending_supervision(self):
        """One device-to-host copy of the deferred supervision counts ->
        node validity flags."""
        with self._lock:
            self.flush_supervision()
            if not self._pending_supervision:
                return
            pending, self._pending_supervision = self._pending_supervision, []
        # the copy waits for the stream: outside the lock
        all_counts = torch.stack([c for _, c in pending]).cpu().numpy()
        with self._lock:
            # only for nodes that still own their slot (allocate_slot may
            # have recycled one meanwhile; its supervision died with it)
            for (nodes, _), counts in zip(pending, all_counts):
                for i, n in enumerate(nodes):
                    if n.buffer_slot >= 0:
                        n._has_supervision = bool(counts[i] > 0)

    def _reproject_update(self, idx: np.ndarray, footprint: np.ndarray, trav: float) -> torch.Tensor:
        """One footprint update over the fan-out.

        idx (B_max,) host slots, == capacity for padding; footprint (P, 3)
        world points; trav the footprint's traversability. Every row is
        projected and filled (one K4 launch of B_max hulls, B_max/dp on each
        dp rank of a mesh, whose rows are then gathered); only the rows of
        real slots are written back. Returns the per-row counts of valid
        segments, (B_max,) on the device."""
        buf, dev = self._buffer, self._device
        cap = buf.capacity
        mine = idx
        if self._dp > 1:
            per = -(-len(idx) // self._dp)
            mine = np.concatenate([idx, np.full(per * self._dp - len(idx), cap, idx.dtype)])
            mine = mine[self._dp_rank * per:(self._dp_rank + 1) * per]
        sel = torch.as_tensor(np.clip(mine, 0, cap - 1), dtype=torch.long, device=dev)
        B = len(mine)
        cam = Camera(K=buf.K[sel], height=self._H, width=self._W)
        pts = torch.as_tensor(footprint, dtype=torch.float32, device=dev)[None].expand(B, -1, 3)
        inside, _, _ = project_and_render(cam, buf.pose_cam_in_world[sel], pts)
        vals = torch.where(inside, torch.tensor(trav, dtype=torch.float32, device=dev), torch.inf)
        fused = torch.minimum(buf.supervision_mask[sel], vals)
        sig, sv = segment_masked_mean(fused, torch.isfinite(fused), buf.seg[sel], self._S)
        if self._dp > 1:
            fused, sig, sv = (all_gather_rows(t, self._dp_group)[:len(idx)] for t in (fused, sig, sv))
        rows = np.flatnonzero(idx < cap)  # padding rows are dropped here, on the host
        r = torch.as_tensor(rows, device=dev)
        s = torch.as_tensor(idx[rows], dtype=torch.long, device=dev)
        buf.supervision_mask[s] = fused[r]
        buf.signal[s] = sig[r]
        buf.signal_valid[s] = sv[r]
        return torch.sum(sv, dim=-1)

    # ------------------------------------------------------- properties
    @property
    def loss(self) -> float:
        return self._loss

    @property
    def step(self) -> int:
        return self._step

    @property
    def params(self) -> dict:
        """The head's parameters by state-dict name (live tensors)."""
        return dict(self._model.state_dict())

    @property
    def confidence_state(self) -> ConfidenceState:
        return self._cg_state

    @property
    def model(self):
        return self._model

    @property
    def optimizer(self) -> torch.optim.Adam:
        return self._optimizer

    @property
    def buffer(self) -> MissionBuffer:
        return self._buffer

    @property
    def pause_learning(self) -> bool:
        return self._pause_training

    @pause_learning.setter
    def pause_learning(self, pause: bool):
        self._pause_training = pause

    @property
    def pause_mission_graph(self) -> bool:
        return self._pause_mission_graph

    @pause_mission_graph.setter
    def pause_mission_graph(self, pause: bool):
        self._pause_mission_graph = pause

    @property
    def pause_supervision_graph(self) -> bool:
        return self._pause_supervision_graph

    @pause_supervision_graph.setter
    def pause_supervision_graph(self, pause: bool):
        self._pause_supervision_graph = pause

    @property
    def lock(self) -> TrackedRLock:
        """The lock serialising mission-buffer access; hold it across an
        external allocate -> write -> commit sequence."""
        return self._lock

    def get_num_valid_nodes(self) -> int:
        self._resolve_pending_supervision()
        return self._mission_graph.get_num_valid_nodes()

    def get_mission_nodes(self):
        return self._mission_graph.get_nodes()

    def get_supervision_nodes(self):
        return self._supervision_graph.get_nodes()

    def get_last_valid_mission_node(self):
        self._resolve_pending_supervision()
        for node in reversed(self._mission_graph.get_nodes()):
            if node.is_valid():
                return node
        return None

    def update_visualization_node(self):
        nodes = self._mission_graph.get_nodes()
        if not nodes:
            return
        self._vis_mission_node = nodes[0] if len(nodes) <= self._vis_node_index else nodes[-self._vis_node_index]

    # ------------------------------------------------------ node intake
    def allocate_slot(self, node: MissionNode) -> Optional[int]:
        """Graph-gate the node and reserve a ring-buffer slot without
        writing the buffer."""
        if self._pause_mission_graph:
            return None
        if not (self._mission_graph.add_node(node) and node.use_for_training):
            return None
        with self._lock:
            # queued footprint updates name slots by index: apply them
            # before a slot is recycled
            if self._slot_to_node.get(self._next_slot % self._buffer.capacity) is not None:
                self.flush_supervision()
            slot = self._next_slot % self._buffer.capacity
            self._next_slot += 1
            node.buffer_slot = slot
            evicted = self._slot_to_node.pop(slot, None)
            if evicted is not None:
                evicted._has_supervision = False
                evicted.buffer_slot = -1
            self._slot_to_node[slot] = node
        return slot

    def commit_buffer(self, new_buffer: MissionBuffer):
        """Adopt a buffer written by an external program (hold `lock`)."""
        with self._lock:
            self._buffer = new_buffer

    def add_mission_node(self, node: MissionNode, features, feat_valid, seg, K_scaled, verbose: bool = False) -> bool:
        """Gate by travel distance, then write the node's training payload
        (features (S, D), feat_valid (S,), seg (H, W), K_scaled (3, 3))
        into the ring buffer."""
        with self._lock:
            slot = self.allocate_slot(node)
            if slot is None:
                return False
            buffer_insert(self._buffer, slot, features, feat_valid, seg, K_scaled, node.pose_cam_in_world)
        if verbose:
            print(f"adding node [{node}], total nodes [{self._mission_graph.get_num_nodes()}]")
        return True

    def add_supervision_node(self, pnode: SupervisionNode) -> bool:
        """Gate, build the footprint against the previous node, and queue
        its reprojection into the in-range mission nodes (applied at once
        unless `supervision_flush_every` > 1)."""
        if self._pause_supervision_graph or not pnode.is_valid():
            return False

        last_pnode = self._supervision_graph.get_last_node()
        if not self._supervision_graph.add_node(pnode):
            if last_pnode is not None:
                last_pnode.update_traversability(pnode.traversability, pnode.traversability_var)
            return False
        if last_pnode is None or not last_pnode.is_valid():
            return False

        footprint = pnode.make_footprint_with_node(last_pnode)
        # static pad to _MAX_FOOTPRINT_POINTS (duplicates do not change the hull)
        P = footprint.shape[0]
        if P > _MAX_FOOTPRINT_POINTS:
            footprint = footprint[np.linspace(0, P - 1, _MAX_FOOTPRINT_POINTS).astype(int)]
        elif P < _MAX_FOOTPRINT_POINTS:
            footprint = np.concatenate([footprint, np.tile(footprint[-1:], (_MAX_FOOTPRINT_POINTS - P, 1))], axis=0)

        last_mission_node = self._mission_graph.get_last_node()
        if last_mission_node is None:
            return False
        mission_nodes = self._mission_graph.get_nodes_within_radius_range(
            last_mission_node, 0.0, self._supervision_graph.max_distance)
        mission_nodes = [n for n in mission_nodes if n.buffer_slot >= 0]
        if not mission_nodes:
            return False
        mission_nodes = mission_nodes[-self._B_max:]

        idx = np.full((self._B_max,), self._buffer.capacity, dtype=np.int64)  # == capacity: padding
        idx[: len(mission_nodes)] = [n.buffer_slot for n in mission_nodes]

        with self._lock:
            self._pending_footprints.append((idx, footprint.astype(np.float32), float(pnode.traversability),
                                             mission_nodes))
            if len(self._pending_footprints) >= self._flush_every:
                self.flush_supervision()
            if self._mode == WVNMode.EXTRACT_LABELS and self._extraction_store_folder:
                self.flush_supervision()
                self._export_supervision_masks(mission_nodes)
        return True

    def _export_supervision_masks(self, mission_nodes):
        """One boolean mask per node: set and non-zero pixels (the
        reference stores nan_to_num(mask) != 0)."""
        folder = os.path.join(self._extraction_store_folder, "supervision_mask")
        os.makedirs(folder, exist_ok=True)
        masks = self._buffer.supervision_mask
        for n in mission_nodes:
            m = masks[n.buffer_slot].cpu().numpy()
            np.save(os.path.join(folder, str(n.timestamp).replace(".", "_") + ".npy"), np.isfinite(m) & (m != 0))

    # --------------------------------------------------------- training
    def _sample_indices(self, batch_size: Optional[int] = None):
        """Locked slot sampling without resolving pending supervision;
        replacement only when fewer valid nodes than the batch size."""
        batch_size = batch_size or self._batch_size
        with self._lock:
            valid = [n for n in self._mission_graph.get_valid_nodes() if n.buffer_slot >= 0]
            if not valid:
                return None
            slots = np.array([n.buffer_slot for n in valid], dtype=np.int32)
        return self._rng.choice(slots, size=batch_size, replace=len(slots) < batch_size)

    def sample_batch_indices(self, batch_size: Optional[int] = None):
        self._resolve_pending_supervision()
        return self._sample_indices(batch_size)

    def _gather(self, idx):
        buf = self._buffer
        i = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=self._device)
        return buf.features[i], buf.signal[i], buf.signal_valid[i], buf.feat_valid[i] & buf.valid[i][:, None]

    def _batch(self, idx, split: bool = True) -> TravBatch:
        """The sampled nodes' TravBatch: (B·S, ...) rows and, for a graph
        head, each node's segment adjacency (recomputed from the stored
        segmentation). Under a mesh (with `split`) only this dp rank's
        nodes. A batch that dp does not divide is padded with copies of its
        last node, every sample masked: they add nothing to a masked sum or
        count, and their losses repeat a real node's, so the minimum and
        maximum over the rows (moving_average's) stay the batch's own."""
        idx = np.asarray(idx)
        n, per = len(idx), -(-len(idx) // self._dp)
        split = split and self._dp > 1
        if split:
            idx = np.concatenate([idx, np.repeat(idx[-1:], per * self._dp - n)])
        fields = list(self._gather(idx))
        if model_needs_edges(self._model):
            i = torch.as_tensor(idx, dtype=torch.long, device=self._device)
            fields += adjacency_list(self._buffer.seg[i], self._S, max_edges=self._max_edges)
        if split:
            fields[3] = fields[3] & (torch.arange(len(idx), device=self._device) < n)[:, None]
            fields = [f[self._dp_rank * per:(self._dp_rank + 1) * per] for f in fields]
        batch = batch_from_arrays(*fields[:4])
        return batch._replace(edges=fields[4], edge_valid=fields[5]) if len(fields) > 4 else batch

    def _loss_on_batch(self, model, batch: TravBatch, cg_state: ConfidenceState, group=None):
        """(loss, aux, new confidence state) of `model` on the batch: the
        confidence-weighted loss, or in anomaly mode the flow over the
        supervised (positively labelled) samples only. A graph head scores
        each node over its own adjacency, all nodes in one graph."""
        if batch.edges is None:
            res = apply_model(model, batch.x)
        else:
            res = apply_model(model, batch.x, *batch_graph(batch.edges, batch.edge_valid, self._S))
        if self._anomaly_detection:
            return anomaly_loss(self._loss_cfg, res, batch.y_valid & batch.sample_valid, cg_state, group=group)
        return traversability_loss(self._loss_cfg, batch, res, cg_state, group=group)

    def step_on_batch(self, model, optimizer, cg_state: ConfidenceState, batch: TravBatch, group=None):
        """The optimisation step on an assembled batch
        (parallel/mesh.py::dp_train_step on this estimator's loss). Shared
        by the estimator's train step and
        parallel/distributed.py::DistributedTrainer, so both run the same
        math. With a group, `batch` is this rank's rows and the loss and
        aux returned are the whole batch's. Returns (loss, aux without the
        per-sample confidence, new confidence state)."""
        return dp_train_step(model, optimizer, lambda: self._loss_on_batch(model, batch, cg_state, group), group)

    def make_batch(self, batch_size: Optional[int] = None):
        """Sampled valid nodes' (features, signal, signal_valid, sample_valid)."""
        idx = self.sample_batch_indices(batch_size)
        if idx is None:
            return None
        with self._lock:
            return self._gather(idx)

    def _train_step(self, idx):
        """gather -> loss -> autograd -> Adam -> confidence state."""
        loss, aux, self._cg_state = self.step_on_batch(self._model, self._optimizer, self._cg_state,
                                                       self._batch(idx), self._dp_group)
        return loss, aux

    def train(self, convert_losses: bool = True) -> dict:
        """One optimisation step once more than `min_samples_for_training`
        nodes are valid. convert_losses=False leaves the losses as device
        scalars (and `loss` stale), so the step does not wait for the card."""
        if self._pause_training:
            return {}
        self._train_calls += 1
        if (self._train_calls % self._resolve_every == 0
                or self._mission_graph.get_num_valid_nodes() <= self._min_samples_for_training):
            self._resolve_pending_supervision()
        num_valid = self._mission_graph.get_num_valid_nodes()
        return_dict = {"mission_graph_num_valid_node": num_valid}
        if num_valid <= self._min_samples_for_training:
            return_dict["loss_total"] = -1
            return return_dict
        with self._lock:
            idx = self._sample_indices(self._batch_size)
            if idx is None:
                return_dict["loss_total"] = -1
                return return_dict
            loss, aux = self._train_step(idx)
        self._step += 1
        if self._log_confidence_folder and self._step % self._log_every == 0:
            os.makedirs(self._log_confidence_folder, exist_ok=True)
            np.savez(os.path.join(self._log_confidence_folder, f"samples_{self._step:06d}.npz"),
                     mean=self._cg_state.mean.cpu().numpy(), std=self._cg_state.std.cpu().numpy(),
                     var=self._cg_state.var.cpu().numpy(), loss=loss.cpu().numpy())
        if convert_losses:
            self._loss = float(loss)
            return_dict.update(loss_total=self._loss, loss_trav=float(aux["loss_trav"]),
                               loss_reco=float(aux["loss_reco"]))
        else:
            return_dict.update(loss_total=loss, loss_trav=aux["loss_trav"], loss_reco=aux["loss_reco"])
        return return_dict

    def adopt_train_state(self, params: dict, adam: Optional[dict], cg_state: ConfidenceState,
                          step: Optional[int] = None):
        """Replace the optimisation state wholesale: params (a state dict),
        adam ({"step", "exp_avg", "exp_avg_sq"}, the moments by param name;
        None for fresh moments), the confidence state and the step.
        `utils.params.train_state_from_jax` builds these from a JAX
        estimator's state."""
        with self._lock:
            self._model.load_state_dict(params)
            self._optimizer = adam_with_moments(self._model, self._lr, adam)
            self._cg_state = ConfidenceState(*(t.to(self._device) for t in cg_state))
            if step is not None:
                self._step = step

    # ------------------------------------------------------ checkpoints
    def state_dict_for_hot_swap(self) -> dict:
        """The params + confidence payload inference polls. A snapshot:
        later train steps update the head in place and leave it as it is."""
        return {
            "params": {k: v.detach().clone() for k, v in self._model.state_dict().items()},
            "confidence_generator": {k: v.clone() for k, v in confidence_state_dict(self._cg_state).items()},
            "step": self._step,
        }

    def save_checkpoint(self, mission_path: str, checkpoint_name: str = "last_checkpoint.ckpt") -> str:
        """Full mission checkpoint in torch's format: model, optimizer,
        confidence state, step, loss."""
        os.makedirs(mission_path, exist_ok=True)
        path = os.path.join(mission_path, checkpoint_name)
        torch.save({
            "params": self._model.state_dict(),
            "opt_state": self._optimizer.state_dict(),
            "cg_state": self._cg_state._asdict(),
            "step": self._step,
            "loss": self._loss,
        }, path)
        return path

    def load_checkpoint(self, checkpoint_path: str):
        payload = torch.load(checkpoint_path, map_location=self._device, weights_only=True)
        self._model.load_state_dict(payload["params"])
        self._optimizer.load_state_dict(payload["opt_state"])
        self._cg_state = ConfidenceState(**payload["cg_state"])
        self._step = payload["step"]
        self._loss = payload["loss"]
        self._pause_training = False
        print(f"Loaded checkpoint from file {checkpoint_path}")

    def load_confidence_state_dict(self, d: dict):
        self._cg_state = confidence_load_state_dict(self._cg_state, d)

    def save_graph(self, mission_path: str):
        """Dataset export for offline training: one npz of features,
        signals and segments per valid slot-holding node."""
        self._resolve_pending_supervision()
        with self._lock:
            buf = self._buffer
            feats, sig, sv, fv, seg = (t.cpu().numpy() for t in
                                       (buf.features, buf.signal, buf.signal_valid, buf.feat_valid, buf.seg))
        os.makedirs(mission_path, exist_ok=True)
        for node in self._mission_graph.get_valid_nodes():
            s = node.buffer_slot
            if s < 0:
                continue
            p = os.path.join(mission_path, f"graph_{str(node.timestamp).replace('.', '_')}.npz")
            np.savez_compressed(p, features=feats[s], signal=sig[s], signal_valid=sv[s], segments=seg[s],
                                feat_valid=fv[s])

    def reset(self):
        """A fresh mission: graphs, buffer, confidence, Adam moments, step
        and loss readout are cleared; the head keeps its weights."""
        with self._lock:
            self._mission_graph.clear()
            self._supervision_graph.clear()
            self._pending_footprints = []
            self._pending_supervision = []
            self._buffer = buffer_init(self._buffer.capacity, self._S, self._D, self._H, self._W, device=self._device)
            self._slot_to_node = {}
            self._next_slot = 0
            self._cg_state = confidence_init(self._device)
            self._step = 0
            self._optimizer = make_adam(self._model.parameters(), self._lr)
            self._loss = float("inf")
            self._train_calls = 0
            self._vis_mission_node = None

    # ------------------------------------------------- whole-object pickle
    # (the reference pickles the entire estimator; the lock and the
    # optimiser are rebuilt on load, tensors travel on the CPU; the mesh
    # holds process groups and is dropped: a loaded estimator runs
    # unmeshed until given a new one)
    def __getstate__(self):
        self._resolve_pending_supervision()  # flushes the queued footprints first
        cpu = torch.device("cpu")
        with self._lock:
            state = self.__dict__.copy()
            state["_pending_supervision"] = []
            state["_pending_footprints"] = []
            del state["_lock"], state["_optimizer"]
            state.update(_mesh=None, _dp=1, _dp_rank=0, _dp_group=None)
            opt = self._optimizer.state_dict()
            state["_optimizer_state"] = {
                "state": {i: {k: v.to(cpu) for k, v in st.items()} for i, st in opt["state"].items()},
                "param_groups": copy.deepcopy(opt["param_groups"]),
            }
            state["_model"] = copy.deepcopy(self._model).to(cpu)
            state["_buffer"] = MissionBuffer(*(t.to(cpu) for t in self._buffer))
            state["_cg_state"] = ConfidenceState(*(t.to(cpu) for t in self._cg_state))
        return state

    def __setstate__(self, state):
        opt_state = state.pop("_optimizer_state")
        self.__dict__.update(state)
        override = getattr(_unpickle_device, "device", None)
        if override is not None:
            self._device = torch.device(override)
        dev = self._device
        self._model = self._model.to(dev)
        self._buffer = MissionBuffer(*(t.to(dev) for t in self._buffer))
        self._cg_state = ConfidenceState(*(t.to(dev) for t in self._cg_state))
        self._optimizer = make_adam(self._model.parameters(), self._lr)
        self._optimizer.load_state_dict(opt_state)  # moves the moments to the parameters' device
        self._lock = TrackedRLock()

    def save_pickle(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)
        return path

    @staticmethod
    def load_pickle(path: str, device=None) -> "TraversabilityEstimator":
        """The pickled estimator on the device it was saved from, or on
        `device` (a pickle taken on the card loads on a CPU-only machine
        with device="cpu")."""
        _unpickle_device.device = device
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        finally:
            _unpickle_device.device = None
