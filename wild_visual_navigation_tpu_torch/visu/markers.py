"""3-D supervision markers — the framework's ROS-free equivalent of the
reference's RViz visualization.

The reference publishes a TRIANGLE_LIST Marker of the driven-footprint
"rainbow ribbon" (two triangles per supervision-node pair, colored by
traversability) plus vertical collision-wall quads for untraversable
nodes, and a Path of the supervision-graph poses
(the reference repository's wild_visual_navigation_ros/scripts/wvn_learning_node.py:690-795).
This module builds the same geometry as plain numpy triangle soups and
exports them to standard formats any 3-D viewer opens (PLY with vertex
colors for MeshLab/Open3D/CloudCompare, JSON for web viewers) —
replacing the visualization_msgs dependency with files.

A copy of wild_visual_navigation_tpu/visu/markers.py (numpy only).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from .visualizer import colormap_rdylbu


@dataclass
class TriangleList:
    """Triangle soup with per-vertex RGBA colors — the Marker
    TRIANGLE_LIST equivalent (wvn_learning_node.py:703-718)."""

    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))  # (N, 3)
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))  # (N, 4) in [0,1]

    def append(self, pts: np.ndarray, rgba: Sequence[float]):
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        self.points = np.concatenate([self.points, pts], axis=0)
        col = np.tile(np.asarray(rgba, np.float32)[None], (pts.shape[0], 1))
        self.colors = np.concatenate([self.colors, col], axis=0)

    @property
    def num_triangles(self) -> int:
        return self.points.shape[0] // 3

    def to_ply(self, path: str):
        """Write an ASCII PLY mesh with vertex colors."""
        n = self.points.shape[0]
        tris = n // 3
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {n}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\nproperty uchar alpha\n")
            f.write(f"element face {tris}\n")
            f.write("property list uchar int vertex_indices\n")
            f.write("end_header\n")
            cols = np.clip(self.colors * 255, 0, 255).astype(np.uint8)
            for p, c in zip(self.points, cols):
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]} {c[3]}\n")
            for t in range(tris):
                f.write(f"3 {3 * t} {3 * t + 1} {3 * t + 2}\n")

    def to_json(self) -> str:
        return json.dumps({
            "type": "triangle_list",
            "points": np.round(self.points, 5).tolist(),
            "colors": np.round(self.colors, 4).tolist(),
        })


def _trav_rgba(traversability: float, alpha: float = 0.95) -> np.ndarray:
    """Reference color_palette(RdYlBu) per node (wvn_learning_node.py:729-731)."""
    rgb = colormap_rdylbu(np.asarray([traversability], np.float32))[0]
    return np.concatenate([rgb.astype(np.float32), [np.float32(alpha)]])


def build_footprint_ribbon(supervision_nodes, untraversable_grid_size: int = 2) -> TriangleList:
    """Driven-footprint ribbon: for each consecutive node pair, two
    triangles spanning the previous side points and the current ones,
    colored by node traversability; untraversable nodes additionally
    contribute their vertical collision-wall quad
    (wvn_learning_node.py:720-791)."""
    tri = TriangleList()
    last = None
    for node in supervision_nodes:
        c = _trav_rgba(float(node.traversability))
        sp = node.get_side_points()  # (2, 3) world
        if last is not None:
            # quad (last0, last1, sp0, sp1) as two triangles
            tri.append(np.stack([last[0], last[1], sp[0]]), c)
            tri.append(np.stack([last[1], sp[0], sp[1]]), c)
        last = sp
        if getattr(node, "is_untraversable", False):
            plane = node.get_untraversable_plane(grid_size=untraversable_grid_size)
            # corner order hack from the reference: 0,1,3,2,0,3 -> 2 tris
            # (wvn_learning_node.py:783-791)
            idx = [0, 1, 3, 2, 0, 3]
            tri.append(plane[idx], c)
    return tri


def build_graph_path(nodes) -> np.ndarray:
    """(N, 3) polyline of node positions in world — the Path message
    equivalent (wvn_learning_node.py:698-727)."""
    if not nodes:
        return np.zeros((0, 3), np.float64)
    return np.stack([np.asarray(n.pose_base_in_world)[:3, 3] for n in nodes])


def export_supervision_markers(supervision_nodes, ply_path: str | None = None,
                               json_path: str | None = None) -> TriangleList:
    """One-call export used by the runtime's visualization cadence:
    build the ribbon and write the requested artifact files."""
    tri = build_footprint_ribbon(supervision_nodes)
    if ply_path:
        tri.to_ply(ply_path)
    if json_path:
        with open(json_path, "w") as f:
            f.write(tri.to_json())
    return tri
