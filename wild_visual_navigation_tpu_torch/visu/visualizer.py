"""Visualization utilities.

A copy of wild_visual_navigation_tpu/visu/visualizer.py, which uses numpy
only (PIL and matplotlib are imported inside the functions that draw
with them). It re-designs the reference LearningVisualizer (the reference
repository's wild_visual_navigation/visu/visualizer.py:31-762).
The hot path — traversability / confidence overlays on camera images —
is pure numpy (a vectorized RdYlBu colormap matching the reference's
stretched matplotlib colormap, visualizer.py:379-384) so it never
blocks the runtime on matplotlib; figure-level plots (learning curves,
mission-node panels) use matplotlib lazily.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# RdYlBu control points (matplotlib's palette), value 0 -> red (low
# traversability), 1 -> blue. The reference stretches the colormap and
# re-registers it (visualizer.py:379-384); colormap_rdylbu(squeeze=0.3)
# reproduces that LUT and is the classification-overlay default.
_RDYLBU = np.array(
    [
        [165, 0, 38],
        [215, 48, 39],
        [244, 109, 67],
        [253, 174, 97],
        [254, 224, 144],
        [255, 255, 191],
        [224, 243, 248],
        [171, 217, 233],
        [116, 173, 209],
        [69, 117, 180],
        [49, 54, 149],
    ],
    dtype=np.float32,
) / 255.0


def colormap_rdylbu(values: np.ndarray, stretch: float = 1.0, squeeze: Optional[float] = None) -> np.ndarray:
    """values in [0,1], any shape -> (..., 3) RGB float.

    squeeze=s reproduces the reference's stretched-LUT construction
    (visualizer.py:378-384): a 256-entry table whose first 128 rows
    sample palette positions [0, s] and last 128 rows sample [1-s, 1] —
    the yellow midband is removed, giving a hard red/blue decision
    boundary at value 0.5.

    squeeze and stretch are mutually exclusive remappings; passing both
    raises (previously squeeze silently won)."""
    if squeeze is not None and stretch != 1.0:
        raise ValueError("colormap_rdylbu: pass either squeeze or stretch, not both")
    v = np.clip(np.nan_to_num(values, nan=0.0), 0.0, 1.0)
    if squeeze is not None:
        i = np.minimum((v * 255).astype(np.int32), 255)
        v = np.where(
            i <= 127,
            squeeze * i / 127.0,
            (1.0 - squeeze) + squeeze * (i - 128) / 127.0,
        ).astype(np.float32)
    elif stretch != 1.0:
        v = np.clip((v - 0.5) * stretch + 0.5, 0.0, 1.0)
    idx = v * (len(_RDYLBU) - 1)
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, len(_RDYLBU) - 1)
    w = (idx - lo)[..., None]
    return _RDYLBU[lo] * (1 - w) + _RDYLBU[hi] * w


def _to_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = img.transpose(1, 2, 0)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.clip(img.astype(np.float32), 0, 1)


class LearningVisualizer:
    def __init__(self, p_visu: Optional[str] = None, store: bool = False):
        self._p_visu = p_visu
        self._store = store and p_visu is not None
        if self._store:
            os.makedirs(p_visu, exist_ok=True)

    def _maybe_store(self, img: np.ndarray, tag: str) -> np.ndarray:
        if self._store:
            from PIL import Image

            Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(self._p_visu, f"{tag}.png"))
        return img

    def plot_detectron_classification(
        self,
        img: np.ndarray,
        prediction: np.ndarray,
        alpha: float = 0.5,
        confidence: Optional[np.ndarray] = None,
        squeeze: Optional[float] = 0.3,
        tag: str = "classification",
    ) -> np.ndarray:
        """Image + colormapped prediction overlay; where `confidence` is
        given it modulates overlay opacity (reference
        plot_detectron_classification, visualizer.py:368-430, including
        its s=0.3 squeezed RdYlBu LUT; pass squeeze=None for the plain
        palette). Returns (H, W, 3) float RGB."""
        base = _to_hwc(img)
        pred = np.asarray(prediction, dtype=np.float32)
        heat = colormap_rdylbu(pred, squeeze=squeeze)
        a = alpha * (np.asarray(confidence, dtype=np.float32)[..., None] if confidence is not None else 1.0)
        out = base * (1 - a) + heat * a
        return self._maybe_store(np.clip(out, 0, 1), tag)

    def plot_traversability_overlay(self, img, traversability, confidence=None, tag="traversability"):
        return self.plot_detectron_classification(img, traversability, confidence=confidence, tag=tag)

    @staticmethod
    def _render_segmentation(seg: np.ndarray, max_seg: Optional[int] = None) -> np.ndarray:
        seg = np.asarray(seg)
        n = int(max_seg if max_seg is not None else seg.max() + 1)
        rng = np.random.RandomState(42)
        palette = rng.rand(max(n, 1), 3).astype(np.float32)
        return palette[np.clip(seg, 0, n - 1)]

    def plot_segmentation(self, seg: np.ndarray, max_seg: Optional[int] = None, tag: str = "segmentation") -> np.ndarray:
        """Random-color segment visualization (reference plot_segmentation)."""
        return self._maybe_store(self._render_segmentation(seg, max_seg), tag)

    def plot_list(self, imgs, tag: str = "list") -> np.ndarray:
        """Horizontal concat of equally-sized images (reference plot_list)."""
        imgs = [_to_hwc(i) for i in imgs]
        out = np.concatenate(imgs, axis=1)
        return self._maybe_store(out, tag)

    def plot_mission_node_prediction(self, image, traversability, confidence, tag="mission_node"):
        """Side-by-side input / trav / confidence panel (reference
        plot_mission_node_prediction, visualizer.py:142-176)."""
        panels = [
            _to_hwc(image),
            colormap_rdylbu(np.asarray(traversability)),
        ]
        if confidence is not None:
            panels.append(colormap_rdylbu(np.asarray(confidence)))
        return self.plot_list(panels, tag=tag)

    def plot_detectron(self, img: np.ndarray, seg: np.ndarray, alpha: float = 0.5,
                       max_seg: Optional[int] = None, draw_labels: bool = False,
                       labels: Optional[dict] = None, tag: str = "detectron") -> np.ndarray:
        """Segmentation overlay with random stable colors (reference
        plot_detectron, visualizer.py:313-366, the detectron2-style
        label overlay). `draw_labels` writes each segment's id (or its
        entry in `labels`) at the segment centroid, like the reference's
        per-label text."""
        base = _to_hwc(img)
        seg = np.asarray(seg)
        seg_rgb = self._render_segmentation(seg, max_seg=max_seg)
        out = np.clip(base * (1 - alpha) + seg_rgb * alpha, 0, 1)
        if draw_labels:
            from PIL import Image, ImageDraw

            pil = Image.fromarray((out * 255).astype(np.uint8))
            draw = ImageDraw.Draw(pil)
            # one vectorized pass for all areas + centroids
            ids, inv, counts = np.unique(seg, return_inverse=True, return_counts=True)
            ys, xs = np.nonzero(np.ones_like(seg, dtype=bool))
            sum_x = np.bincount(inv.ravel(), weights=xs, minlength=len(ids))
            sum_y = np.bincount(inv.ravel(), weights=ys, minlength=len(ids))
            for i, sid in enumerate(ids):
                if counts[i] < 20:  # skip slivers, like the reference's area gate
                    continue
                text = str(labels.get(int(sid), int(sid))) if labels else str(int(sid))
                draw.text((sum_x[i] / counts[i], sum_y[i] / counts[i]), text,
                          fill=(255, 255, 255), anchor="mm")
            out = np.asarray(pil).astype(np.float32) / 255.0
        return self._maybe_store(out, tag)

    def plot_graph_on_image(self, img: np.ndarray, points_2d: np.ndarray,
                            values: Optional[np.ndarray] = None, radius: int = 2,
                            tag: str = "graph") -> np.ndarray:
        """Render projected graph/trajectory points onto the image
        (reference graph-on-image rendering, visualizer.py:251-309):
        each (x, y) point is drawn as a colormapped dot."""
        out = _to_hwc(img).copy()
        H, W, _ = out.shape
        pts = np.asarray(points_2d)
        vals = np.asarray(values) if values is not None else np.ones(len(pts))
        colors = colormap_rdylbu(vals)
        for (x, y), c in zip(pts, colors):
            xi, yi = int(round(float(x))), int(round(float(y)))
            if not (0 <= xi < W and 0 <= yi < H):
                continue
            y0, y1 = max(0, yi - radius), min(H, yi + radius + 1)
            x0, x1 = max(0, xi - radius), min(W, xi + radius + 1)
            out[y0:y1, x0:x1] = c
        return self._maybe_store(out, tag)

    def plot_optical_flow(self, img: np.ndarray, points: np.ndarray, flow: np.ndarray,
                          valid: Optional[np.ndarray] = None, tag: str = "flow") -> np.ndarray:
        """Sparse flow-field rendering (reference plot_optical_flow,
        visualizer.py:541-614): line segments from each point along its
        flow vector, colored by magnitude."""
        out = _to_hwc(img).copy()
        H, W, _ = out.shape
        pts, fl = np.asarray(points), np.asarray(flow)
        v = np.ones(len(pts), bool) if valid is None else np.asarray(valid)
        mags = np.linalg.norm(fl, axis=-1)
        maxm = max(float(mags.max()), 1e-6)
        colors = colormap_rdylbu(1.0 - mags / maxm)
        for (x, y), (dx, dy), ok, c in zip(pts, fl, v, colors):
            if not ok:
                continue
            n = max(int(np.hypot(dx, dy)), 1)
            for t in np.linspace(0, 1, n + 1):
                xi, yi = int(round(x + t * dx)), int(round(y + t * dy))
                if 0 <= xi < W and 0 <= yi < H:
                    out[yi, xi] = c
        return self._maybe_store(out, tag)

    @staticmethod
    def _fig_to_numpy(fig) -> np.ndarray:
        """matplotlib figure -> (H, W, 3) float RGB (the reference's
        get_img_from_fig, visu/plotting.py:13)."""
        import matplotlib.pyplot as plt

        fig.canvas.draw()
        w, h = fig.canvas.get_width_height()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8).reshape(h, w, 4)[..., :3]
        plt.close(fig)
        return buf.astype(np.float32) / 255.0

    def plot_learning_curve(self, steps, losses, tag: str = "learning_curve") -> Optional[np.ndarray]:
        """Loss-vs-step plot via matplotlib (offline/debug path)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 3))
        ax.plot(steps, losses)
        ax.set_xlabel("step")
        ax.set_ylabel("loss")
        fig.tight_layout()
        return self._maybe_store(self._fig_to_numpy(fig), tag)

    def plot_roc(self, x, y, y_lower=None, y_upper=None, y_tag=None,
                 tag: str = "roc") -> np.ndarray:
        """ROC curve(s) with optional confidence bands and the chance
        diagonal (reference plot_roc, visualizer.py:73-125). Accepts a
        single curve or lists of curves."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if not isinstance(x, (list, tuple)):
            x, y = [x], [y]
            y_lower = [y_lower] if y_lower is not None else None
            y_upper = [y_upper] if y_upper is not None else None
            y_tag = [y_tag]
        n = len(x)
        y_lower = y_lower or [None] * n
        y_upper = y_upper or [None] * n
        y_tag = y_tag or [None] * n

        fig, ax = plt.subplots(figsize=(3, 3))
        for xi, yi, lo, hi, lab in zip(x, y, y_lower, y_upper, y_tag):
            (line,) = ax.plot(xi, yi, label=lab)
            if lo is not None and hi is not None:
                ax.fill_between(xi, lo, hi, color=line.get_color(), alpha=0.2)
        diag = np.linspace(0, 1, 100)
        ax.plot(diag, diag, linestyle="--", color="gray")
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        if any(t is not None for t in y_tag):
            ax.legend(loc="lower right")
        fig.tight_layout()
        return self._maybe_store(self._fig_to_numpy(fig), tag)

    def plot_histogram(self, reco_loss, y, mean, std, tag: str = "histogram") -> np.ndarray:
        """Reconstruction-loss histogram: all samples vs positive
        (footprint-labeled) samples, overlaid with the confidence
        generator's gaussian (reference plot_histogram,
        visualizer.py:127-139)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        losses = np.asarray(reco_loss, dtype=np.float32).ravel()
        labels = np.asarray(y).ravel()
        bins = np.linspace(0, 4, 100)
        fig, ax = plt.subplots(figsize=(3, 3))
        ax.hist(losses, bins, alpha=0.5, color="k")
        ax.hist(losses[labels == 1], bins, alpha=0.5, color="b")
        std = max(float(std), 1e-6)
        ax.plot(bins, np.exp(-((bins - float(mean)) ** 2) / (2 * std**2)), color="b", linewidth=3)
        fig.tight_layout()
        return self._maybe_store(self._fig_to_numpy(fig), tag)

    def plot_traversability_graph(
        self,
        prediction: np.ndarray,
        edges: np.ndarray,
        centers: np.ndarray,
        img: np.ndarray,
        node_valid: Optional[np.ndarray] = None,
        edge_valid: Optional[np.ndarray] = None,
        colorize_invalid_centers: bool = False,
        radius: int = 5,
        tag: str = "traversability_graph",
    ) -> np.ndarray:
        """Segment-graph rendering on the camera image (reference
        plot_traversability_graph, visualizer.py:251-309): gray lines
        along adjacency edges, per-node discs colored by the predicted
        traversability (RdYlBu); invalid nodes gray unless
        `colorize_invalid_centers`.

        prediction: (S,) in [0,1]; edges: (2, E) segment-id pairs;
        centers: (S, 2) (x, y) pixel positions; img: (3, H, W)/(H, W, 3).
        """
        return self._maybe_store(
            self._render_traversability_graph(
                prediction, edges, centers, img, node_valid=node_valid,
                edge_valid=edge_valid,
                colorize_invalid_centers=colorize_invalid_centers, radius=radius,
            ),
            tag,
        )

    def _render_traversability_graph(
        self,
        prediction: np.ndarray,
        edges: np.ndarray,
        centers: np.ndarray,
        img: np.ndarray,
        node_valid: Optional[np.ndarray] = None,
        edge_valid: Optional[np.ndarray] = None,
        colorize_invalid_centers: bool = False,
        radius: int = 5,
    ) -> np.ndarray:
        """Rendering body without the store side effect (used by the
        composite plots so intermediates never hit disk)."""
        from PIL import Image, ImageDraw

        base = (_to_hwc(img) * 255).astype(np.uint8)
        pil = Image.fromarray(base)
        draw = ImageDraw.Draw(pil)
        pred = np.clip(np.asarray(prediction, np.float32), 0, 1)
        centers = np.asarray(centers, np.float32)
        S = centers.shape[0]
        valid = np.ones(S, bool) if node_valid is None else np.asarray(node_valid, bool)
        colors = (colormap_rdylbu(pred) * 255).astype(np.uint8)

        edges = np.asarray(edges)
        ev = np.ones(edges.shape[1], bool) if edge_valid is None else np.asarray(edge_valid, bool)
        for e in range(edges.shape[1]):
            if not ev[e]:
                continue
            a, b = int(edges[0, e]), int(edges[1, e])
            if not (0 <= a < S and 0 <= b < S):
                continue
            draw.line([tuple(centers[a]), tuple(centers[b])], fill=(127, 127, 127))
        for i in range(S):
            x, y = float(centers[i, 0]), float(centers[i, 1])
            box = [x - radius, y - radius, x + radius, y + radius]
            if valid[i] or colorize_invalid_centers:
                draw.ellipse(box, fill=tuple(int(c) for c in colors[i]))
            else:
                draw.ellipse(box, fill=(127, 127, 127))
        return np.asarray(pil).astype(np.float32) / 255.0

    def plot_traversability_graph_on_seg(
        self,
        prediction: np.ndarray,
        seg: np.ndarray,
        edges: np.ndarray,
        centers: np.ndarray,
        img: np.ndarray,
        alpha: float = 0.6,
        tag: str = "traversability_graph_on_seg",
    ) -> np.ndarray:
        """Per-segment prediction gathered onto the segmentation map,
        overlaid on the image (reference plot_traversability_graph_on_seg,
        visualizer.py:208-248)."""
        base = _to_hwc(img)
        pred = np.clip(np.asarray(prediction, np.float32), 0, 1)
        seg = np.asarray(seg)
        m = pred[np.clip(seg, 0, len(pred) - 1)]
        heat = colormap_rdylbu(m)
        out = np.clip(base * (1 - alpha) + heat * alpha, 0, 1)
        return self._maybe_store(out, tag)

    def plot_graph_result(
        self,
        y: np.ndarray,
        y_pred: np.ndarray,
        edges: np.ndarray,
        centers: np.ndarray,
        img: np.ndarray,
        node_valid: Optional[np.ndarray] = None,
        tag: str = "graph_result",
    ) -> np.ndarray:
        """Side-by-side ground-truth and prediction graphs on the image
        (reference plot_graph_result, visualizer.py:425-470)."""
        gt = self._render_traversability_graph(
            np.clip(np.asarray(y, np.float32), 0, 1), edges, centers, img,
            node_valid=node_valid,
        )
        pr = self._render_traversability_graph(
            np.clip(np.asarray(y_pred, np.float32), 0, 1), edges, centers, img,
            node_valid=node_valid,
        )
        return self._maybe_store(np.concatenate([gt, pr], axis=1), tag)

    def plot_mission_node_training(
        self,
        image: np.ndarray,
        supervision_signal: np.ndarray,
        supervision_mask: np.ndarray,
        seg: np.ndarray,
        edges: np.ndarray,
        centers: np.ndarray,
        tag: str = "mission_node_training",
    ):
        """Training-view panel for a mission node (reference
        plot_mission_node_training, visualizer.py:176-206): the
        per-segment supervision signal as a graph plot, plus the raw
        reprojected supervision mask overlay (unset pixels transparent —
        the reference's NaN mask; here +inf/NaN both count as unset).

        Returns (supervision_graph_img, mask_overlay_img)."""
        sup_img = self._render_traversability_graph(
            np.clip(np.nan_to_num(np.asarray(supervision_signal, np.float32)), 0, 1),
            edges, centers, image,
        )
        mask = np.asarray(supervision_mask, np.float32)
        unset = ~np.isfinite(mask)
        vals = np.where(unset, 0.0, mask)
        heat = colormap_rdylbu(vals)
        base = _to_hwc(image)
        a = np.where(unset, 0.0, 0.6)[..., None]
        mask_img = np.clip(base * (1 - a) + heat * a, 0, 1)
        self._maybe_store(sup_img, tag + "_graph")
        self._maybe_store(mask_img, tag + "_mask")
        return sup_img, mask_img

    def plot_sparse_optical_flow(
        self,
        pre_pos: np.ndarray,
        cur_pos: np.ndarray,
        img1: np.ndarray,
        img2: np.ndarray,
        valid: Optional[np.ndarray] = None,
        tag: str = "sparse_flow",
    ) -> np.ndarray:
        """Cross-image correspondence rendering (reference
        plot_sparse_optical_flow, visualizer.py:574-614): img1 | img2
        side by side with green lines from each tracked point in img1 to
        its match in img2."""
        from PIL import Image, ImageDraw

        i1 = (_to_hwc(img1) * 255).astype(np.uint8)
        i2 = (_to_hwc(img2) * 255).astype(np.uint8)
        both = np.concatenate([i1, i2], axis=1)
        pil = Image.fromarray(both)
        draw = ImageDraw.Draw(pil)
        W = i1.shape[1]
        pre, cur = np.asarray(pre_pos, np.float32), np.asarray(cur_pos, np.float32)
        v = np.ones(len(pre), bool) if valid is None else np.asarray(valid, bool)
        for p, c, ok in zip(pre, cur, v):
            if not ok or not (np.isfinite(p).all() and np.isfinite(c).all()):
                continue
            draw.line([(float(p[0]), float(p[1])), (float(W + c[0]), float(c[1]))],
                      fill=(0, 255, 0), width=2)
        return self._maybe_store(np.asarray(pil).astype(np.float32) / 255.0, tag)
