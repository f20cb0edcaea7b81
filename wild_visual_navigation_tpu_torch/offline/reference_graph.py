"""Loader for the reference's recorded-mission graph fixture.

Copy of wild_visual_navigation_tpu/offline/reference_graph.py. The
reference implementation ships one piece of real-world data in its
`assets/graph/`: a pyg ``Data`` graph of 100 STEGO segments from a forest
mission (`graph.pt`: 90-dim features ``x``, segment adjacency
``edge_index``, self-supervised labels ``y`` / ``y_valid``), the segment
centres (`center.pt`), the rendered camera image (`img.png`, 448x448) and
the reference model's own stored predictions on that graph
(`trav_pred.pt` (100,), `reco_pred.pt` (100, 90)).

The port looks for those files in this repository's `assets/graph/`
(`REFERENCE_GRAPH_DIR`); they are not committed yet, so the tools that need
them stop with a message until they are.

Unpickling `graph.pt` needs torch_geometric classes the environment does
not ship; the payload is two plain containers (``Data`` with a ``_store``
dict and ``GlobalStorage`` with a ``_mapping`` dict), so minimal stubs are
registered for the duration of the load. Everything is returned as numpy.
"""

from __future__ import annotations

import contextlib
import os
import sys
import types
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

REFERENCE_GRAPH_DIR = str(Path(__file__).resolve().parents[2] / "assets" / "graph")


@dataclass
class ReferenceGraph:
    x: np.ndarray            # (S, D) real STEGO features, float32
    edge_index: np.ndarray   # (2, E) segment adjacency, int64
    y: np.ndarray            # (S,) self-supervised labels in {0, 1}
    y_valid: np.ndarray      # (S,) bool — footprint-labeled segments
    centers: np.ndarray      # (S, 2) segment centers in image pixels (x, y)
    trav_pred: np.ndarray    # (S,) reference model's stored traversability
    reco_pred: np.ndarray    # (S, D) reference model's stored reconstruction
    img: np.ndarray          # (H, W, 3) float32 in [0, 1]

    @property
    def num_segments(self) -> int:
        return self.x.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.x.shape[1]


def available(root: str = REFERENCE_GRAPH_DIR) -> bool:
    return os.path.isfile(os.path.join(root, "graph.pt"))


@contextlib.contextmanager
def _pyg_stub_modules():
    """Temporarily register torch_geometric stub modules for unpickling.

    pyg's Data pickles as (Data.__reduce__ -> __setstate__ with a dict
    holding ``_store``); GlobalStorage pickles its mapping.  The stubs
    accept either and keep the raw dicts. Pre-existing real modules (if
    any) are left untouched and restored afterwards.
    """
    names = [
        "torch_geometric",
        "torch_geometric.data",
        "torch_geometric.data.data",
        "torch_geometric.data.storage",
    ]
    saved = {n: sys.modules.get(n) for n in names}

    class _Data:
        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else dict(state))

    class _GlobalStorage(dict):
        def __init__(self, *a, **k):
            super().__init__()

        def __setstate__(self, state):
            self.update(state if isinstance(state, dict) else dict(state))

    class _DataEdgeAttr:
        pass

    class _DataTensorAttr:
        pass

    tg = types.ModuleType("torch_geometric")
    tgd = types.ModuleType("torch_geometric.data")
    tgdd = types.ModuleType("torch_geometric.data.data")
    tgst = types.ModuleType("torch_geometric.data.storage")
    tgdd.Data = _Data
    tgdd.DataEdgeAttr = _DataEdgeAttr
    tgdd.DataTensorAttr = _DataTensorAttr
    tgst.GlobalStorage = _GlobalStorage
    tgd.Data = _Data
    tgd.data = tgdd
    tgd.storage = tgst
    tg.data = tgd
    try:
        for name, mod in [(names[0], tg), (names[1], tgd), (names[2], tgdd), (names[3], tgst)]:
            sys.modules[name] = mod
        yield
    finally:
        for n in names:
            if saved[n] is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = saved[n]


def load_reference_graph(root: str = REFERENCE_GRAPH_DIR) -> ReferenceGraph:
    """Load the full fixture (PIL is imported here, for the image)."""
    from PIL import Image

    with _pyg_stub_modules():
        g = torch.load(os.path.join(root, "graph.pt"), map_location="cpu", weights_only=False)
    store = g.__dict__["_store"]
    mapping = store["_mapping"] if "_mapping" in store else store

    def _np(t):
        return t.detach().cpu().numpy()

    x = _np(mapping["x"]).astype(np.float32)
    edge_index = _np(mapping["edge_index"]).astype(np.int64)
    y = _np(mapping["y"]).astype(np.float32)
    y_valid = _np(mapping["y_valid"]).astype(bool)

    centers = _np(torch.load(os.path.join(root, "center.pt"), map_location="cpu")).astype(np.float32)
    trav_pred = _np(torch.load(os.path.join(root, "trav_pred.pt"), map_location="cpu")).astype(np.float32)
    reco_pred = _np(torch.load(os.path.join(root, "reco_pred.pt"), map_location="cpu")).astype(np.float32)
    img = np.asarray(Image.open(os.path.join(root, "img.png"))).astype(np.float32) / 255.0

    return ReferenceGraph(
        x=x, edge_index=edge_index, y=y, y_valid=y_valid,
        centers=centers, trav_pred=trav_pred, reco_pred=reco_pred, img=img,
    )


def reference_confidence(reco_pred: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Numpy equivalent of the reference's get_confidence
    (utils/get_confidence.py:10-14): min-max-normalized inverse
    per-sample reconstruction MSE."""
    res = ((reco_pred - x) ** 2).mean(axis=1)
    res = res - res.min()
    rng = res.max()
    if rng > 0:
        res = res / rng
    return 1.0 - res
