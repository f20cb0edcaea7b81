"""Pose-graph containers (host side).

A copy of wild_visual_navigation_tpu/traversability/graphs.py (numpy
only), kept in the port so that it never imports the JAX package.
Re-design of the reference's networkx-backed graphs (upstream WVN's
traversability_estimator/graphs.py:14-316). The reference stored CUDA tensors inside networkx node attributes; here
the graph is a plain ordered list of light nodes plus PARALLEL numpy
pose (N, 4, 4) / timestamp (N,) arrays kept in sync on insert/evict —
radius-range queries, window eviction, and timespan queries are one
vectorized batched-SE(3) / boolean-mask op each instead of per-pair
python loops. The heavy per-node tensors live in the estimator's device
ring buffer. Same public API surface (add_node gating by min edge
distance, radius-range / timespan queries, random valid nodes, window
eviction variants). Thread-safe via one mutex like the reference
(graphs.py:32).
"""

from __future__ import annotations

import random
import threading
from typing import List, Optional

import numpy as np

from .nodes import BaseNode, se3_trans_dist_batch_np

_INITIAL_CAPACITY = 64


class BaseGraph:
    def __init__(self, edge_distance: float = 0.0):
        """Only adds a node if it is at least `edge_distance` away from
        the last node (reference graphs.py:15-69)."""
        self._edge_distance = edge_distance or 0.0
        self._lock = threading.Lock()
        self._nodes: List[BaseNode] = []
        self._first_node: Optional[BaseNode] = None
        self._poses = np.zeros((_INITIAL_CAPACITY, 4, 4))
        self._stamps = np.zeros((_INITIAL_CAPACITY,))
        # lifetime count of nodes dropped by window/FIFO eviction (not
        # explicit remove_nodes) — observability for long missions,
        # where eviction semantics must stay correct after many recycles
        self.evictions_total = 0

    # pickling support (reference graphs.py:37-46)
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self.__dict__.setdefault("evictions_total", 0)  # pre-r5 pickles

    def __str__(self):
        return f"graph with {len(self._nodes)} nodes"

    # ------------------------------------------------ array bookkeeping
    def _append(self, node: BaseNode):
        """Append under the lock, growing the parallel arrays 2x."""
        n = len(self._nodes)
        if n == self._poses.shape[0]:
            self._poses = np.concatenate([self._poses, np.zeros_like(self._poses)])
            self._stamps = np.concatenate([self._stamps, np.zeros_like(self._stamps)])
        self._poses[n] = node.pose_base_in_world
        self._stamps[n] = node.timestamp
        self._nodes.append(node)

    def _apply_keep(self, keep: np.ndarray):
        """Compact nodes + arrays to keep[i] == True, under the lock."""
        if keep.all():
            return
        idx = np.flatnonzero(keep)
        self._poses[: len(idx)] = self._poses[idx]
        self._stamps[: len(idx)] = self._stamps[idx]
        self._nodes = [self._nodes[i] for i in idx]

    def _distances_to(self, node: BaseNode) -> np.ndarray:
        """Vectorized SE(3) translational distance from `node` to every
        stored node (call under the lock)."""
        n = len(self._nodes)
        with np.errstate(invalid="ignore"):
            return se3_trans_dist_batch_np(
                np.asarray(node.pose_base_in_world, dtype=np.float64), self._poses[:n]
            )

    # ----------------------------------------------------------- mutate
    def add_node(self, node: BaseNode) -> bool:
        with self._lock:
            if self._nodes and self._edge_distance > 0:
                if self._nodes[-1].distance_to(node) < self._edge_distance:
                    return False
            self._append(node)
            if self._first_node is None:
                self._first_node = node
            self._evict(node)
            return True

    def _evict(self, new_node: BaseNode):
        """Hook for windowed subclasses; called under the lock."""

    def clear(self):
        with self._lock:
            self._nodes = []
            self._poses = np.zeros((_INITIAL_CAPACITY, 4, 4))
            self._stamps = np.zeros((_INITIAL_CAPACITY,))
            self._first_node = None  # else get_first_node outlives the clear

    def remove_nodes(self, nodes: List[BaseNode]):
        with self._lock:
            drop = {id(n) for n in nodes}
            keep = np.array([id(n) not in drop for n in self._nodes], dtype=bool)
            self._apply_keep(keep)

    def remove_nodes_within_radius_range(self, node: BaseNode, min_radius: float, max_radius: float):
        to_remove = self.get_nodes_within_radius_range(node, min_radius, max_radius)
        self.remove_nodes(to_remove)

    def remove_nodes_within_timestamp(self, t_ini: float, t_end: float):
        to_remove = self.get_nodes_within_timespan(t_ini, t_end)
        self.remove_nodes(to_remove)

    # ------------------------------------------------------------ query
    def get_first_node(self):
        return self._first_node

    def get_last_node(self):
        with self._lock:
            return self._nodes[-1] if self._nodes else None

    def get_previous_node(self, node: BaseNode):
        with self._lock:
            try:
                i = self._nodes.index(node)
            except ValueError:
                return None
            return self._nodes[i - 1] if i > 0 else None

    def get_num_nodes(self) -> int:
        with self._lock:
            return len(self._nodes)

    def get_num_valid_nodes(self) -> int:
        with self._lock:
            return sum(1 for n in self._nodes if n.is_valid())

    def get_nodes(self) -> List[BaseNode]:
        with self._lock:
            return sorted(self._nodes)

    def get_valid_nodes(self) -> List[BaseNode]:
        with self._lock:
            return sorted(n for n in self._nodes if n.is_valid())

    def get_n_random_valid_nodes(self, n: Optional[int] = None) -> List[BaseNode]:
        nodes = self.get_valid_nodes()
        random.shuffle(nodes)
        return nodes if n is None else nodes[:n]

    def get_node_with_timestamp(self, timestamp: float, eps: float = 1e-12):
        with self._lock:
            n = len(self._nodes)
            if n == 0:
                return None
            diffs = np.abs(self._stamps[:n] - timestamp)
            i = int(np.argmin(diffs))
            return self._nodes[i] if diffs[i] < eps else None

    def get_nodes_within_radius_range(
        self, node: BaseNode, min_radius: float, max_radius: float, time_eps: float = 1.0
    ) -> List[BaseNode]:
        """Pose-distance query, one vectorized batched-SE(3) op. The
        reference runs single-source Dijkstra over the chain graph
        (graphs.py:154-184), whose path distance over a chain equals
        summed consecutive edge lengths; for window sizes of a few
        meters the direct SE(3) distance matches it on robot
        trajectories and is O(N) vectorized instead of O(N log N)
        python. Degenerate poses yield NaN distances and are excluded
        (the reference's per-pair try/except)."""
        with self._lock:
            d = self._distances_to(node)
            mask = (d >= min_radius) & (d <= max_radius)
            return sorted(self._nodes[i] for i in np.flatnonzero(mask))

    def get_nodes_within_timespan(self, t_ini: float, t_end: float, open_interval: bool = False) -> List[BaseNode]:
        with self._lock:
            s = self._stamps[: len(self._nodes)]
            if open_interval:
                mask = (s > t_ini) & (s < t_end)
            else:
                mask = (s >= t_ini) & (s <= t_end)
            return sorted(self._nodes[i] for i in np.flatnonzero(mask))


class MaxElementsGraph(BaseGraph):
    """FIFO-capped graph (reference graphs.py:232-261).

    `keep_fn`: optional predicate sparing individual nodes from FIFO
    eviction (e.g. mission nodes that still own a ring-buffer slot —
    their count is bounded by the buffer capacity, so the graph stays
    bounded by max_elements + that external bound)."""

    def __init__(self, edge_distance: float = 0.0, max_elements: int = -1, keep_fn=None):
        super().__init__(edge_distance)
        self._max_elements = max_elements
        self._keep_fn = keep_fn

    def _evict(self, new_node: BaseNode):
        n = len(self._nodes)
        if self._max_elements <= 0 or n <= self._max_elements:
            return
        overflow = n - self._max_elements
        keep = np.ones(n, dtype=bool)
        dropped = 0
        # never consider the node being inserted (index n-1): the caller
        # (estimator.allocate_slot) assigns its buffer slot only AFTER
        # add_node, so keep_fn would see buffer_slot == -1 and evict it
        # — leaving an orphan slot the graph (and sampling) never sees
        for i in range(n - 1):
            if dropped >= overflow:
                break
            if self._keep_fn is None or not self._keep_fn(self._nodes[i]):
                keep[i] = False
                dropped += 1
        self.evictions_total += dropped
        self._apply_keep(keep)


class TemporalWindowGraph(BaseGraph):
    """Drops nodes older than `time_window` (reference graphs.py:264-286)."""

    def __init__(self, edge_distance: float = 0.0, time_window: float = float("inf")):
        super().__init__(edge_distance)
        self._time_window = time_window

    def _evict(self, new_node: BaseNode):
        n = len(self._nodes)
        keep = self._stamps[:n] >= (new_node.timestamp - self._time_window)
        self.evictions_total += int(n - keep.sum())
        self._apply_keep(keep)


class DistanceWindowGraph(BaseGraph):
    """Drops nodes farther than `max_distance` from the newest node
    (reference graphs.py:289-316)."""

    def __init__(self, edge_distance: float = 0.0, max_distance: float = float("inf")):
        super().__init__(edge_distance)
        self._max_distance = max_distance

    @property
    def max_distance(self) -> float:
        return self._max_distance

    def _evict(self, new_node: BaseNode):
        d = self._distances_to(new_node)
        keep = d <= self._max_distance  # NaN distances are dropped
        self.evictions_total += int(len(keep) - keep.sum())
        self._apply_keep(keep)
