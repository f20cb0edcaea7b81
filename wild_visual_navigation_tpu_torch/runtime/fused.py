"""Per-frame inference: segmentation + backbone + pooling + head.

Port of wild_visual_navigation_tpu/runtime/fused.py, its DINO, STEGO and
torchvision frame functions:

    image -> resize / normalise -> ViT dense features (K1 in every block)
    -> SLIC (K3) or grid segmentation -> per-segment pooling, adjacency
    and centres -> per-pixel MLP traversability + confidence (K2)

    image -> resize / normalise -> ViT-B/8 (K1) -> STEGO code head ->
    per-image cosine k-means -> code pooling, adjacency and centres at
    patch resolution -> per-pixel (K2) or per-segment scoring

    image -> resize / normalise -> ResNet or EfficientNet pyramid -> SLIC
    (K3) or grid segmentation -> multiscale per-segment pooling ->
    per-segment scoring, gathered over the segmentation

Heads: SimpleMLP / DoubleMLP return [trav || reconstruction], and the
confidence comes from the reconstruction error; a LinearRnvp (anomaly
mode) returns {z, log_det, logprob}, its traversability is the calibrated
flow likelihood and its confidence 1; a SimpleGCN (graph head) scores per
segment over the frame's segment adjacency, whatever the prediction mode.
Only a SimpleMLP reconstruction head goes through K2; the others score
the upsampled features in row bands (`pixelwise_map_rows_chunked`).

On the card the whole DINO frame replays as one CUDA graph per input key,
the head and the ConfidenceState copied into the graph's own when a hot
swap publishes new ones; the STEGO frame's backbone stage (uint8 to float,
resize, normalise, the ViT, the code head) replays as one, and k-means and
the head run eagerly on a copy of its codes (`StageGraphs`). Each frame
pools and builds its graph its own way, and `_score_frame` scores them all.

Under a ("dp", "tp") mesh, `frames_batch(..., mesh=mesh)` splits the frames
over dp (padding B up to a multiple of dp), runs each rank's share and
gathers the results, so every rank holds all B; a tp-sharded ViT
(models/vit.py::shard_heads_) runs its own collectives inside.

The ViT and the head are nn.Modules that carry their weights, so the
returned `frame(cg_state, img)` takes only what changes between frames.
A caller that swaps heads while frames run (the runtime's params mailbox)
passes its own snapshot as `head=`: the frame then reads every layer from
that one module, never from one that training updates in place.
"""

from __future__ import annotations

import copy
import threading
import warnings
from typing import NamedTuple

import torch

from ..models.registry import apply_model, model_needs_edges
from ..models.stego_head import cosine_kmeans, kmeans_init_indices
from ..models.vit import dense_features
from ..ops import _cuda, segment_ops
from ..ops.pixelwise import pixelwise_map_rows_chunked, pixelwise_score
from ..ops.pixelwise import supports_optimized as pixelwise_supports
from ..ops.resize import imagenet_normalize, interpolate_bilinear, resize_image
from ..ops.slic import slic_batch
from ..parallel.mesh import dp_split
from ..utils.confidence_generator import ConfidenceConfig, ConfidenceState, confidence_inference
from ..utils.devices import resident
from ..utils.timers import count, span

KMEANS_ITERATIONS = 10  # the STEGO frame's Lloyd steps (models/stego_head.py::cosine_kmeans' default)


class FrameResult(NamedTuple):
    traversability: torch.Tensor  # (H, W)
    confidence: torch.Tensor  # (H, W)
    features: torch.Tensor  # (S, D) pooled
    feat_valid: torch.Tensor  # (S,)
    segments: torch.Tensor  # (H, W) int32
    edges: torch.Tensor  # (2, E)
    edge_valid: torch.Tensor  # (E,)
    centers: torch.Tensor  # (S, 2)


def _score_rows(mlp, cg_cfg, cg_state, x, anomaly: bool = False, edges=None, edge_valid=None):
    """(N, D) feature rows -> (trav (N,), conf (N,)). In anomaly mode the
    traversability is the confidence of the flow's negative log-likelihood
    and the confidence is 1. Graph heads take the frame's adjacency."""
    out = apply_model(mlp, x, edges, edge_valid)
    if anomaly:
        losses = torch.sum(out["logprob"], dim=-1) + out["log_det"]
        trav = confidence_inference(cg_cfg, cg_state, -losses)
        return trav, torch.ones_like(trav)
    reco = torch.mean((out[:, 1:] - x.float()) ** 2, dim=-1)
    return out[:, 0], confidence_inference(cg_cfg, cg_state, reco)


def _score_frame(mlp, cg_cfg, cg_state, pooled, seg, edges, edge_valid, pixels=None, anomaly: bool = False):
    """One frame's (trav, conf) maps. A graph head scores the (S, D) pooled
    rows over the frame's adjacency, whatever `pixels`. Another head scores
    per pixel from `pixels`: a (trav, conf) pair already scored (K2 over the
    batch, `_k2_batch`), or pixels(score) that scores the frame's rows with
    score(rows) -> (trav, conf) (in row bands, or at patch resolution and
    then interpolated); with no `pixels`, per segment. Per-segment scores
    are gathered over seg (H, W)."""
    if pixels is not None and not model_needs_edges(mlp):
        return pixels if isinstance(pixels, tuple) else pixels(
            lambda rows: _score_rows(mlp, cg_cfg, cg_state, rows, anomaly))
    t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled, anomaly, edges, edge_valid)
    sid = seg.long().clamp(0, pooled.shape[0] - 1)
    return t_s[sid], c_s[sid]


def _k2_batch(mlp, cg_cfg, cg_state, feat, H: int, W: int, per_pixel: bool, at_patch_res: bool = False,
              anomaly: bool = False):
    """Each image's (trav, conf) maps, (H, W), from one K2 launch over the
    batch's (B, D, Hp, Wp) features where the frame scores per pixel at
    full resolution with a head K2 takes (pixelwise.supports_optimized);
    else None, and each image scores its own pixels."""
    if per_pixel and not at_patch_res and not anomaly and pixelwise_supports(mlp):
        return list(zip(*pixelwise_score(mlp, feat, H, W, cg_cfg, cg_state)))
    return None


def _network_input(imgs: torch.Tensor, H: int | None = None, W: int | None = None):
    """(B, 3, H0, W0) frames, uint8 or float in [0, 1] -> (the float frames
    resized to (H, W), as they are where H is None; those normalised)."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() / 255.0
    x = imgs if H is None else resize_image(imgs, H, W)
    return x, imagenet_normalize(x)


def _segmentation(segmentation_type: str, H: int, W: int, S: int, slic_compactness: float, slic_iterations: int,
                  cell_size: int, max_edges: int):
    """SLIC (K3 on the card) or the fixed grid: segments(x) for a (B, 3, H, W)
    batch -> (B, H, W) ids, and graph(seg) for one (H, W) segmentation ->
    (edges, edge_valid, centers); the grid's ids and graph are built once
    and kept on each device they are asked for on."""
    if segmentation_type == "slic":
        def segments(x):
            return slic_batch(x, num_components=S, compactness=slic_compactness, iterations=slic_iterations)

        def graph(seg):
            edges, edge_valid = segment_ops.adjacency_list(seg, S, max_edges=max_edges)
            return edges, edge_valid, segment_ops.segment_centers(seg, S)[0]

        return segments, graph
    grid_graph = segment_ops.grid_constants(H, W, cell_size, S, max_edges=max_edges)

    def segments(x):
        ids = resident(("grid_ids", x.device, H, W, cell_size),
                       lambda: segment_ops.segment_grid(H, W, cell_size, device=x.device))
        return ids[None].expand(x.shape[0], H, W)

    def graph(seg):
        edges, edge_valid, centers, _ = resident(("grid_graph", seg.device, H, W, cell_size, S, max_edges),
                                                 lambda: tuple(t.to(seg.device) for t in grid_graph))
        return edges, edge_valid, centers

    return segments, graph


class _Graph:
    """One key's captured stage, or the reason the key runs eagerly. `own`
    holds the tensors of the graph's copies of the stage's static inputs
    (`StageGraphs`), `fed` the inputs they were last copied from and those
    inputs' tensor versions then."""

    __slots__ = ("reason", "graph", "static_in", "out", "launches", "own", "fed", "lock", "done")

    def __init__(self, reason=None, graph=None, static_in=None, out=None, launches=None, own=(), fed=((), [])):
        self.reason, self.graph, self.static_in, self.out, self.launches = reason, graph, static_in, out, launches
        self.own, self.fed = own, fed
        self.lock = threading.Lock()
        self.done = None if graph is None else torch.cuda.Event()  # recorded after the last replay's copies out


def _split_reason(vit) -> str | None:
    """Why this process cannot replay the ViT's forward alone: "tp" where
    shard_heads_ split it, "mesh" where it reduces its activation scales or
    counts its batch over a process group (share_scales_); else None."""
    if any(blk.attn.tp_group is not None or blk.mlp.tp_group is not None for blk in vit.blocks):
        return "tp"
    if any(getattr(m, "scale_group", None) is not None or getattr(m, "batch_group", None) is not None
           for m in vit.modules()):
        return "mesh"
    return None


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors of a stage's static input: a module's parameters and
    buffers, or a NamedTuple's tensors (a ConfidenceState)."""
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    return [t for t in obj if isinstance(t, torch.Tensor)]


def _static_copy(obj):
    """A graph's own copy of a static input: the module deep-copied, or the
    NamedTuple with its tensors cloned."""
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).requires_grad_(False)
    return obj._make(t.clone() if isinstance(t, torch.Tensor) else t for t in obj)


class StageGraphs:
    """A frame's stage, `stage(imgs, *static)` -> a tuple or NamedTuple of
    tensors, as one CUDA graph per key: (device, B, C, H0, W0, dtype, each
    static input's structure, the ViT's quantisation and generation). The
    DINO frame's stage is the whole frame (the backbone, SLIC or the grid,
    pooling, adjacency, K2 and the confidence) with the head and the
    ConfidenceState as static inputs; the STEGO frame's is its backbone
    (the ViT and the frozen code head), with none. A static input's
    structure is its type and its tensors' shapes and dtypes, so what the
    stage decides from the head (K2 or row bands, graph or row head) is
    decided at capture.

    `graphs(imgs, *static)`: a key's first call runs the stage on a side
    stream, as its own result and as the warm-up that builds the resident
    constants (utils/devices.py::resident), then captures it from its own
    copies of the static inputs (`capture_error_mode="thread_local"`, so a
    learner thread's work goes on meanwhile). Later calls, under the key's
    lock, copy the frame into the graph's static input, copy in the static
    inputs that are other objects than those last copied (a hot swap
    publishes a new head and ConfidenceState) or whose tensors were written
    in place since (`frame.graph.head_copies`), replay on the caller's
    stream and hand out copies of the graph's outputs; an event recorded
    after the copies holds the next caller's copy-in back on the device. A
    replay adds the kernel launches its capture recorded to the wrappers'
    counters.

    CPU input, a ViT split over tp or reducing over a mesh, and a key whose
    capture raised (warned once) run the stage eagerly. Counters
    `frame.graph.captures`, `.replays`, `.head_copies`, `.eager.<reason>`
    (`cpu`, `tp`, `mesh`, `capture`; `mesh` also for a meshed
    `frames_batch`). The span `frame.graph` times a replay and a key's first
    call; the stage opens its own spans where it runs."""

    def __init__(self, vit, stage):
        self.vit, self.stage = vit, stage
        self.graphs: dict = {}  # key -> _Graph, of the ViT's current generation only
        self._capture_lock = threading.Lock()
        self._side: dict = {}  # device -> the capture's stream
        self._seen: dict = {}  # static input's position -> (the last object there, its tensors, its structure)
        self._warned = False

    def _inspect(self, i: int, obj) -> tuple:
        """(tensors, structure) of the static input at position i."""
        seen = self._seen.get(i)
        if seen is None or seen[0] is not obj:
            tensors = _tensors(obj)
            seen = self._seen[i] = (obj, tensors, (type(obj), *((tuple(t.shape), t.dtype) for t in tensors)))
        return seen[1], seen[2]

    def _fed(self, static: tuple) -> tuple:
        """(the static inputs, their tensors' versions): what a graph copied."""
        return static, [t._version for i, obj in enumerate(static) for t in self._inspect(i, obj)[0]]

    def key(self, imgs: torch.Tensor, *static) -> tuple:
        return (imgs.device, *imgs.shape, imgs.dtype, *(self._inspect(i, obj)[1] for i, obj in enumerate(static)),
                self.vit.quant, self.vit.generation)

    def __call__(self, imgs: torch.Tensor, *static):
        if imgs.device.type != "cuda":
            count("frame.graph.eager.cpu")
            return self.stage(imgs, *static)
        key = self.key(imgs, *static)
        g = self.graphs.get(key)
        if g is None:
            with span("frame.graph"):
                g, out = self._capture(key, imgs, static)
            if out is not None:  # this call ran the key's warm-up
                return out
        if g.reason is not None:
            count(f"frame.graph.eager.{g.reason}")
            return self.stage(imgs, *static)
        with g.lock:
            stream = torch.cuda.current_stream(imgs.device)
            with span("frame.graph"):
                stream.wait_event(g.done)
                g.static_in.copy_(imgs)
                self._refresh(g, static)
                g.graph.replay()
                _cuda.count_recorded(g.launches)
                count("frame.graph.replays")
                out = [t.clone() for t in g.out]
            g.done.record(stream)
        return g.out._make(out) if hasattr(g.out, "_make") else tuple(out)

    def _refresh(self, g: _Graph, static: tuple) -> None:
        """Copy the static inputs into the graph's own copies where they are
        other objects than the ones last copied or were written in place
        since, on the caller's stream."""
        fed = self._fed(static)
        if all(a is b for a, b in zip(fed[0], g.fed[0])) and fed[1] == g.fed[1]:
            return
        torch._foreach_copy_(g.own, [t for i, obj in enumerate(static) for t in self._inspect(i, obj)[0]])
        g.fed = fed
        count("frame.graph.head_copies")

    def _capture(self, key: tuple, imgs: torch.Tensor, static: tuple):
        """(the key's _Graph, this call's result if it ran the warm-up, else
        None); the graph is captured here unless another thread did."""
        with self._capture_lock:
            g = self.graphs.get(key)
            if g is not None:
                return g, None
            # graphs of an older generation hold tensors the ViT no longer has
            self.graphs = {k: v for k, v in self.graphs.items() if k[-1] == key[-1]}
            reason, out = _split_reason(self.vit), None
            if reason is None:
                out, g = self._record(key, imgs, static)
                reason = "capture" if g is None else None
            if reason is None:
                count("frame.graph.captures")
            else:
                g = _Graph(reason)
            self.graphs[key] = g
            return g, out

    def _record(self, key: tuple, imgs: torch.Tensor, static: tuple):
        """The stage on the side stream (raises where it raises), then its
        capture from a static input and copies of the static inputs: (the
        stage's result, the _Graph or None where the capture raised)."""
        cur = torch.cuda.current_stream(imgs.device)
        side = self._side.get(imgs.device)
        if side is None:
            side = self._side[imgs.device] = torch.cuda.Stream(imgs.device)
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                out = self.stage(imgs, *static)
                static_in = torch.empty_like(imgs)
                fed = self._fed(static)
                own = tuple(_static_copy(obj) for obj in static)
                graph = torch.cuda.CUDAGraph()
                try:
                    with _cuda.recording_launches() as launches:
                        graph.capture_begin(capture_error_mode="thread_local")
                        try:
                            static_out = self.stage(static_in, *own)
                        finally:
                            graph.capture_end()
                except Exception as exc:  # noqa: BLE001 - the key runs eagerly instead
                    if not self._warned:
                        self._warned = True
                        warnings.warn(f"the stage at {key} could not be captured as a CUDA graph ({exc!r}); it "
                                      "runs eagerly", stacklevel=4)
                    return out, None
        finally:
            cur.wait_stream(side)
        return out, _Graph(None, graph, static_in, static_out, launches, [t for obj in own for t in _tensors(obj)], fed)


def _wire(frame_of, stage, tail, default_mlp, graphs: StageGraphs | None = None):
    """frame(cg_state, img, head=None) -> FrameResult, with
    frame.frames_batch(cg_state, imgs, head=None, mesh=None), which runs the
    stage through `graphs` (eagerly where there are none, or under a mesh),
    frames_batch.graphs, frames_batch.eager(cg_state, imgs, head=None) and
    frame.tail. frame_of(run, cg_state, imgs, mlp) -> FrameResult is a
    frame with run(imgs, *static) for the stage."""

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor, head=None, mesh=None) -> FrameResult:
        mlp = default_mlp if head is None else head
        if mesh is not None:
            if graphs is not None:
                count("frame.graph.eager.mesh")
            return dp_split(mesh, lambda x: frame_of(stage, cg_state, x, mlp), imgs)
        return frame_of(graphs or stage, cg_state, imgs, mlp)

    @torch.no_grad()
    def eager(cg_state: ConfidenceState, imgs: torch.Tensor, head=None) -> FrameResult:
        return frame_of(stage, cg_state, imgs, default_mlp if head is None else head)

    def frame(cg_state: ConfidenceState, img: torch.Tensor, head=None) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img, head)))

    frames_batch.graphs = graphs
    frames_batch.eager = eager
    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame


def _whole(run, cg_state, imgs, mlp) -> FrameResult:
    """A frame whose stage is all of it, the head and the ConfidenceState its static inputs."""
    return run(imgs, mlp, cg_state)


def build_fused_frame_fn(
    vit,
    mlp,
    cg_cfg: ConfidenceConfig,
    input_size: int,
    segmentation_type: str = "slic",
    num_segments: int = 100,
    slic_compactness: float = 10.0,
    slic_iterations: int = 10,
    cell_size: int = 32,
    max_edges: int = 1024,
    prediction_per_pixel: bool = True,
    score_at_patch_res: bool = False,
    input_width: int | None = None,
    anomaly: bool = False,
):
    """Returns frame(cg_state, img, head=None) -> FrameResult, with
    frame.frames_batch(cg_state, imgs, head=None) -> FrameResult of
    stacked fields and frame.tail(cg_state, feat, segs, head=None), the
    post-backbone stage. `head` scores in place of `mlp`. On the card the
    whole frame replays as a CUDA graph, the head and the ConfidenceState
    copied in when they change (`StageGraphs`, as `frames_batch.graphs`);
    `frames_batch.eager(cg_state, imgs, head=None)` runs it eagerly, for
    comparison. Spans: `frame.graph` around a replay (and a key's first
    call); `frame.backbone`, `frame.segment` and `frame.head` where the
    frame runs eagerly.

    img: (1, 3, H0, W0) in [0, 1], float or uint8. Output maps are
    (input_size, input_width or input_size). Square configs resize the
    smaller edge and centre-crop; rectangular ones resize directly and
    must be patch-aligned. `anomaly` scores with a LinearRnvp head: never
    through K2, per pixel in row bands or per segment."""
    if segmentation_type not in ("slic", "grid"):
        raise ValueError(f"fused path does not support segmentation [{segmentation_type}]")
    H = input_size
    W = input_width or input_size
    ps = vit.cfg.patch_size
    if W != H and (H % ps or W % ps):
        raise ValueError(f"rectangular fused config must be patch-aligned: {H}x{W} with patch {ps}")
    S = num_segments
    default_mlp = mlp
    _segments, _graph = _segmentation(segmentation_type, H, W, S, slic_compactness, slic_iterations, cell_size,
                                      max_edges)

    def _one(mlp, cg_state, feat_i, seg, k2=None):
        """Per-image tail. feat_i (D, Hp, Wp); seg (H, W); k2 the image's
        (trav, conf) when the batch was scored per pixel already."""
        edges, edge_valid, centers = _graph(seg)
        D, Hp, Wp = feat_i.shape
        if score_at_patch_res and not model_needs_edges(mlp):  # graph heads pool at full resolution
            ph, pw = H // Hp, W // Wp
            pooled, counts = segment_ops.segment_mean_pool(feat_i, seg[ph // 2 :: ph, pw // 2 :: pw][:Hp, :Wp], S)

            def rows(score):  # per patch, then interpolated
                return tuple(interpolate_bilinear(m.reshape(1, 1, Hp, Wp), H, W)[0, 0]
                             for m in score(feat_i.reshape(D, -1).T))
        else:
            pooled, counts = segment_ops.segment_mean_pool_upsampled(feat_i.float(), seg, S, H, W)

            def rows(score):
                return pixelwise_map_rows_chunked(score, feat_i[None], H, W)
        trav, conf = _score_frame(mlp, cg_cfg, cg_state, pooled, seg, edges, edge_valid,
                                  (k2 or rows) if prediction_per_pixel else None, anomaly)
        return FrameResult(trav, conf, pooled, counts > 0, seg, edges, edge_valid, centers)

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, feat: torch.Tensor, segs: torch.Tensor, head=None) -> FrameResult:
        """feat (B, D, Hp, Wp), segs (B, H, W) -> FrameResult with a
        leading batch axis on every field."""
        mlp = default_mlp if head is None else head
        k2 = _k2_batch(mlp, cg_cfg, cg_state, feat, H, W, prediction_per_pixel, score_at_patch_res, anomaly)
        outs = [_one(mlp, cg_state, feat[b], segs[b], k2 and k2[b]) for b in range(feat.shape[0])]
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    def _frames(imgs: torch.Tensor, mlp, cg_state: ConfidenceState) -> FrameResult:
        with span("frame.backbone"):
            x, normed = _network_input(imgs, H, W)
            feat = dense_features(vit, normed)
        with span("frame.segment"):
            segs = _segments(x)
        with span("frame.head"):
            return tail(cg_state, feat, segs, mlp)

    return _wire(_whole, _frames, tail, mlp, StageGraphs(vit, _frames))


def build_fused_stego_frame_fn(
    stego,
    mlp,
    cg_cfg: ConfidenceConfig,
    input_size: int,
    max_edges: int = 1024,
    prediction_per_pixel: bool = True,
    input_width: int | None = None,
    init_idx: torch.Tensor | None = None,
):
    """The STEGO frame: returns frame(cg_state, img, head=None) ->
    FrameResult, with frame.frames_batch(cg_state, imgs, head=None) (the
    backbone and the code head once on the batch, then the tail) and
    frame.tail(cg_state, codes, head=None) for (B, N, 90) codes.

    `stego` is a feature_extractor/stego.py::StegoInterface. Segments are
    the per-image k-means clusters (S = stego.n_image_clusters,
    KMEANS_ITERATIONS Lloyd steps), features the 90-d code pooled per
    cluster at patch resolution. The JAX package seeds k-means with the
    same key on every frame; the port draws the initial indices once, here,
    from a torch.Generator seeded 0 (or takes `init_idx`, (S,)), and every
    image of every frame starts from them. Rectangular configs must be
    patch-aligned.

    On the card the backbone stage (uint8 to float, resize, normalise, the
    ViT, the code head) replays as a CUDA graph (`StageGraphs`, as
    `frames_batch.graphs`; `frames_batch.eager` runs it eagerly), and the
    tail runs eagerly on a copy of its codes. Spans: `frame.graph` around a
    replay (and a key's first call), `frame.backbone` where the stage runs
    eagerly, then in the tail `frame.segment` (k-means and the labels'
    nearest upsample) and `frame.head` (K2, pooling, adjacency and
    centres); counters `frame.segment.kmeans.images` and
    `frame.segment.kmeans.steps` (images x Lloyd steps)."""
    H = input_size
    W = input_width or input_size
    ps = stego.vit.cfg.patch_size
    if W != H and (H % ps or W % ps):
        raise ValueError(f"rectangular fused stego config must be patch-aligned: {H}x{W} with patch {ps}")
    S = stego.n_image_clusters
    hp, wp = H // ps, W // ps
    if init_idx is None:
        init_idx = kmeans_init_indices(torch.Generator().manual_seed(0), hp * wp, S)
    init_key = tuple(init_idx.tolist())
    default_mlp = mlp

    def nearest(n_out: int, n_in: int, device):
        """The integer nearest-upsample map (y · n_in) // n_out on `device`."""
        return resident(("nearest_upsample", device, n_out, n_in),
                        lambda: (torch.arange(n_out, device=device) * n_in) // n_out)

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, codes: torch.Tensor, head=None) -> FrameResult:
        """codes (B, N, 90) -> FrameResult with a leading batch axis."""
        mlp = default_mlp if head is None else head
        B, dev = codes.shape[0], codes.device
        idx = resident(("kmeans_init", dev, init_key), lambda: init_idx.to(dev))
        with span("frame.segment"):
            labels, _ = cosine_kmeans(codes, idx, KMEANS_ITERATIONS)
            count("frame.segment.kmeans.images", B)
            count("frame.segment.kmeans.steps", B * KMEANS_ITERATIONS)
            seg_p = labels.reshape(B, hp, wp)
            # the integer rule (y · hp) // H, the map upsampled_adjacency_and_centers assumes
            segs = seg_p[:, nearest(H, hp, dev)][:, :, nearest(W, wp, dev)]
        with span("frame.head"):
            code_hw = codes.reshape(B, hp, wp, -1).permute(0, 3, 1, 2)
            k2 = _k2_batch(mlp, cg_cfg, cg_state, code_hw, H, W, prediction_per_pixel)
            outs = []
            for b in range(B):
                pooled, counts = segment_ops.segment_mean_pool(code_hw[b], seg_p[b], S)
                edges, edge_valid, centers, _ = segment_ops.upsampled_adjacency_and_centers(seg_p[b], S, H, W,
                                                                                             max_edges=max_edges)
                pixels = k2[b] if k2 else lambda score: pixelwise_map_rows_chunked(score, code_hw[b : b + 1], H, W)
                trav, conf = _score_frame(mlp, cg_cfg, cg_state, pooled, segs[b], edges, edge_valid,
                                          pixels if prediction_per_pixel else None)
                outs.append(FrameResult(trav, conf, pooled, counts > 0, segs[b], edges, edge_valid, centers))
            return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    def _backbone(imgs: torch.Tensor) -> tuple[torch.Tensor]:
        """(B, 3, H0, W0) -> ((B, N, 90) codes of the resized frames,)."""
        with span("frame.backbone"):
            out = stego.vit(_network_input(imgs, H, W)[1])
            return (stego.head(out["patch_tokens"])["code"],)

    def _codes_then_tail(run, cg_state, imgs, mlp) -> FrameResult:
        return tail(cg_state, *run(imgs), mlp)

    return _wire(_codes_then_tail, _backbone, tail, mlp, StageGraphs(stego.vit, _backbone))


def build_fused_torchvision_frame_fn(
    tvi,
    mlp,
    cg_cfg: ConfidenceConfig,
    input_size: int,
    segmentation_type: str = "slic",
    num_segments: int = 100,
    slic_compactness: float = 10.0,
    slic_iterations: int = 10,
    cell_size: int = 32,
    max_edges: int = 1024,
    input_width: int | None = None,
):
    """The CNN-pyramid frame: returns frame(cg_state, img, head=None) ->
    FrameResult, with frame.frames_batch(cg_state, imgs, head=None) (the
    pyramid and SLIC once on the batch, then the per-image tail) and
    frame.tail(cg_state, pyramid, segs, head=None) for a level dict of
    (B, C_i, H_i, W_i) and (B, H, W) segmentations. It runs eagerly
    (`frames_batch.graphs` is None).

    `tvi` is a feature_extractor/torchvision_interface.py::TorchVisionInterface.
    The mode is per segment by construction (the reference's multiscale
    sparsify path): the maps are the per-segment scores gathered over the
    segmentation. Any rectangle works: the convolutions pad."""
    if segmentation_type not in ("slic", "grid"):
        raise ValueError(f"fused torchvision path does not support segmentation [{segmentation_type}]")
    H = input_size
    W = input_width or input_size
    S = num_segments
    default_mlp = mlp
    _segments, _graph = _segmentation(segmentation_type, H, W, S, slic_compactness, slic_iterations, cell_size,
                                      max_edges)

    def _one(mlp, cg_state, pyr_i, seg):
        """Per-image tail: multiscale pooling and scoring over the
        segmentation. pyr_i: {name: (C_i, H_i, W_i)}."""
        edges, edge_valid, centers = _graph(seg)
        pooled, seg_valid = segment_ops.segment_pyramid_pool(pyr_i, seg, S)
        trav, conf = _score_frame(mlp, cg_cfg, cg_state, pooled, seg, edges, edge_valid)
        return FrameResult(trav, conf, pooled, seg_valid, seg, edges, edge_valid, centers)

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, pyramid: dict, segs: torch.Tensor, head=None) -> FrameResult:
        """pyramid {name: (B, C_i, H_i, W_i)}, segs (B, H, W) -> FrameResult
        with a leading batch axis on every field."""
        mlp = default_mlp if head is None else head
        outs = [_one(mlp, cg_state, {k: v[b] for k, v in pyramid.items()}, segs[b]) for b in range(segs.shape[0])]
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    def _frames(imgs: torch.Tensor, mlp, cg_state: ConfidenceState) -> FrameResult:
        x, normed = _network_input(imgs, H, W)
        return tail(cg_state, tvi.model(normed), _segments(x), mlp)

    return _wire(_whole, _frames, tail, mlp)


def build_fused_batch_fn(vit, mlp):
    """The bare backbone and head as one batched function, for timing
    stages apart: frames(imgs) takes (B, 3, H, W) frames already at network
    size, uint8 or float in [0, 1], and returns the per-patch
    traversability (B, Hp, Wp), with no resize, segmentation or
    confidence (the product's batched path is build_fused_frame_fn's
    frames_batch). The counterpart of the JAX package's function of the
    same name; K1 runs in every block on the card."""

    @torch.no_grad()
    def frames(imgs: torch.Tensor) -> torch.Tensor:
        feat = dense_features(vit, _network_input(imgs)[1])  # (B, D, Hp, Wp)
        B, D, Hp, Wp = feat.shape
        return mlp(feat.permute(0, 2, 3, 1).reshape(-1, D))[:, 0].reshape(B, Hp, Wp)

    return frames
