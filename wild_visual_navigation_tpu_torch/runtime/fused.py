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
the head run eagerly on its outputs (`StageGraphs`).

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

import contextlib
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
        self.done = None if graph is None else torch.cuda.Event()  # recorded where the last holder's reads end


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
    """A frame's stage, `stage(imgs, *static)`, as one CUDA graph per key:
    (device, B, C, H0, W0, dtype, each static input's structure, the ViT's
    quantisation and generation). The DINO frame's stage is the whole frame
    (`whole`: the backbone, SLIC or the grid, pooling, adjacency, K2 and the
    confidence) with the head and the ConfidenceState as static inputs;
    the STEGO frame's is its backbone (the ViT and the frozen code head),
    with none. A static input's structure is its type and its tensors'
    shapes and dtypes, so what the stage decides from the head (K2 or row
    bands, graph or row head) is decided at capture.

    `with graphs(imgs, *static) as out:` a key's first call runs the stage
    on a side stream, as its own result and as the warm-up that builds the
    resident constants (utils/devices.py::resident), then captures it from
    its own copies of the static inputs (`capture_error_mode=
    "thread_local"`, so a learner thread's work goes on meanwhile). Later
    calls copy the frame into the graph's static input and replay on the
    caller's stream, under the key's lock: the next caller's copy-in waits
    for the block to end, on the host and, through an event, on the device.
    Before a replay, static inputs that are other objects than those last
    copied (a hot swap publishes a new head and ConfidenceState), or whose
    tensors were written in place since, are copied into the graph's
    (`<counters>.head_copies`). A whole frame's replay hands out copies of
    the graph's outputs; a backbone's hands out the outputs themselves, to
    read inside the block. A replay adds the kernel launches its capture
    recorded to the wrappers' counters.

    CPU input, a ViT split over tp or reducing over a mesh, and a key whose
    capture raised (warned once) run the stage eagerly. Counters under
    `frame.graph` for a whole frame, else `frame.backbone.graph`:
    `.captures`, `.replays`, `.head_copies`, `.eager.<reason>` (`cpu`, `tp`,
    `mesh`, `capture`; `mesh` also for a meshed `frames_batch`). A replay
    and a key's first call are timed by the span `frame.graph` for a whole
    frame, which opens its own spans when it runs eagerly; a backbone's
    replay, first call and eager run by `frame.backbone`."""

    def __init__(self, vit, stage, whole: bool = False):
        self.vit, self.stage, self.whole = vit, stage, whole
        self.span_name, self.counters = ("frame.graph", "frame.graph") if whole else ("frame.backbone",
                                                                                     "frame.backbone.graph")
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

    @contextlib.contextmanager
    def eager(self, imgs: torch.Tensor, *static):
        with contextlib.nullcontext() if self.whole else span(self.span_name):
            out = self.stage(imgs, *static)
        yield out

    @contextlib.contextmanager
    def __call__(self, imgs: torch.Tensor, *static):
        if imgs.device.type != "cuda":
            count(f"{self.counters}.eager.cpu")
            with self.eager(imgs, *static) as out:
                yield out
            return
        key = self.key(imgs, *static)
        g = self.graphs.get(key)
        if g is None:
            with span(self.span_name):
                g, out = self._capture(key, imgs, static)
            if out is not None:  # this call ran the key's warm-up
                yield out
                return
        if g.reason is not None:
            count(f"{self.counters}.eager.{g.reason}")
            with self.eager(imgs, *static) as out:
                yield out
            return
        with g.lock:
            stream = torch.cuda.current_stream(imgs.device)
            with span(self.span_name):
                stream.wait_event(g.done)
                g.static_in.copy_(imgs)
                self._refresh(g, static)
                g.graph.replay()
                _cuda.count_recorded(g.launches)
                count(f"{self.counters}.replays")
                out = g.out._make(t.clone() for t in g.out) if self.whole else g.out
            try:
                yield out
            finally:
                g.done.record(stream)

    def _refresh(self, g: _Graph, static: tuple) -> None:
        """Copy the static inputs into the graph's own copies where they are
        other objects than the ones last copied or were written in place
        since, on the caller's stream."""
        fed = self._fed(static)
        if all(a is b for a, b in zip(fed[0], g.fed[0])) and fed[1] == g.fed[1]:
            return
        torch._foreach_copy_(g.own, [t for i, obj in enumerate(static) for t in self._inspect(i, obj)[0]])
        g.fed = fed
        count(f"{self.counters}.head_copies")

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
                count(f"{self.counters}.captures")
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
    call); `frame.backbone`, `frame.segment` and `frame.head` on the eager
    paths.

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

    def _one(mlp, cg_state, feat_i, seg, trav=None, conf=None):
        """Per-image tail. feat_i (D, Hp, Wp); seg (H, W); trav / conf
        are given when the batch was scored per pixel already."""
        edges, edge_valid, centers = _graph(seg)
        D, Hp, Wp = feat_i.shape
        sid = seg.long().clamp(0, S - 1)
        if model_needs_edges(mlp):
            # graph heads score per segment over the frame's adjacency
            pooled, counts = segment_ops.segment_mean_pool_upsampled(feat_i.float(), seg, S, H, W)
            t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled, anomaly, edges, edge_valid)
            return FrameResult(t_s[sid], c_s[sid], pooled, counts > 0, seg, edges, edge_valid, centers)
        if score_at_patch_res:
            ph, pw = H // Hp, W // Wp
            pooled, counts = segment_ops.segment_mean_pool(feat_i, seg[ph // 2 :: ph, pw // 2 :: pw][:Hp, :Wp], S)
            if prediction_per_pixel:
                t_r, c_r = _score_rows(mlp, cg_cfg, cg_state, feat_i.reshape(D, -1).T, anomaly)
                trav = interpolate_bilinear(t_r.reshape(1, 1, Hp, Wp), H, W)[0, 0]
                conf = interpolate_bilinear(c_r.reshape(1, 1, Hp, Wp), H, W)[0, 0]
        else:
            pooled, counts = segment_ops.segment_mean_pool_upsampled(feat_i.float(), seg, S, H, W)
            if prediction_per_pixel and trav is None:
                trav, conf = pixelwise_map_rows_chunked(
                    lambda rows: _score_rows(mlp, cg_cfg, cg_state, rows, anomaly), feat_i[None], H, W)
        if not prediction_per_pixel:
            t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled, anomaly)
            trav, conf = t_s[sid], c_s[sid]
        return FrameResult(trav, conf, pooled, counts > 0, seg, edges, edge_valid, centers)

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, feat: torch.Tensor, segs: torch.Tensor, head=None) -> FrameResult:
        """feat (B, D, Hp, Wp), segs (B, H, W) -> FrameResult with a
        leading batch axis on every field."""
        mlp = default_mlp if head is None else head
        trav_b = conf_b = None
        if prediction_per_pixel and not score_at_patch_res and not anomaly and pixelwise_supports(mlp):
            # Gram per-pixel scorer over the whole batch: one K2 launch
            trav_b, conf_b = pixelwise_score(mlp, feat, H, W, cg_cfg, cg_state)
        outs = [
            _one(mlp, cg_state, feat[b], segs[b], None if trav_b is None else trav_b[b], None if conf_b is None else conf_b[b])
            for b in range(feat.shape[0])
        ]
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    def _backbone(imgs: torch.Tensor):
        """(B, 3, H0, W0) -> the resized (B, 3, H, W) image the segmentation
        takes and the (B, D, Hp, Wp) features."""
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        x = resize_image(imgs, H, W)
        return x, dense_features(vit, imagenet_normalize(x))

    def _frames(imgs: torch.Tensor, mlp, cg_state: ConfidenceState) -> FrameResult:
        with span("frame.backbone"):
            x, feat = _backbone(imgs)
        with span("frame.segment"):
            segs = _segments(x)
        with span("frame.head"):
            return tail(cg_state, feat, segs, mlp)

    graphs = StageGraphs(vit, _frames, whole=True)

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor, head=None, mesh=None) -> FrameResult:
        """(B, 3, H0, W0) -> FrameResult with a leading batch axis; the
        backbone, SLIC and the per-pixel scorer each run once on the batch."""
        mlp = default_mlp if head is None else head
        if mesh is not None:
            count("frame.graph.eager.mesh")
            return dp_split(mesh, lambda x: _frames(x, mlp, cg_state), imgs)
        with graphs(imgs, mlp, cg_state) as out:
            return out

    @torch.no_grad()
    def eager(cg_state: ConfidenceState, imgs: torch.Tensor, head=None) -> FrameResult:
        return _frames(imgs, default_mlp if head is None else head, cg_state)

    def frame(cg_state: ConfidenceState, img: torch.Tensor, head=None) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img, head)))

    frames_batch.graphs = graphs
    frames_batch.eager = eager
    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame


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
    `frames_batch.backbone`; `frames_batch.eager` runs it eagerly). Spans:
    `frame.backbone`, then in the tail `frame.segment` (k-means and the
    labels' nearest upsample) and `frame.head` (K2, pooling, adjacency and
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
    default_mlp = mlp
    per_device: dict = {}

    def constants(device):
        """The initial indices and the integer nearest-upsample maps on `device`."""
        if device not in per_device:
            per_device[device] = (init_idx.to(device), (torch.arange(H, device=device) * hp) // H,
                                  (torch.arange(W, device=device) * wp) // W)
        return per_device[device]

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, codes: torch.Tensor, head=None) -> FrameResult:
        """codes (B, N, 90) -> FrameResult with a leading batch axis."""
        mlp = default_mlp if head is None else head
        B = codes.shape[0]
        idx, iy, ix = constants(codes.device)
        with span("frame.segment"):
            labels, _ = cosine_kmeans(codes, idx, KMEANS_ITERATIONS)
            count("frame.segment.kmeans.images", B)
            count("frame.segment.kmeans.steps", B * KMEANS_ITERATIONS)
            seg_p = labels.reshape(B, hp, wp)
            # the integer rule (y · hp) // H, the map upsampled_adjacency_and_centers assumes
            segs = seg_p[:, iy][:, :, ix]
        with span("frame.head"):
            code_hw = codes.reshape(B, hp, wp, -1).permute(0, 3, 1, 2)
            trav_b = conf_b = None
            if prediction_per_pixel and pixelwise_supports(mlp):
                trav_b, conf_b = pixelwise_score(mlp, code_hw, H, W, cg_cfg, cg_state)  # one K2 launch
            outs = []
            for b in range(B):
                pooled, counts = segment_ops.segment_mean_pool(code_hw[b], seg_p[b], S)
                edges, edge_valid, centers, _ = segment_ops.upsampled_adjacency_and_centers(seg_p[b], S, H, W,
                                                                                             max_edges=max_edges)
                if model_needs_edges(mlp):
                    # graph heads: per-segment scoring over the cluster adjacency
                    t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled, edges=edges, edge_valid=edge_valid)
                    sid = segs[b].long().clamp(0, S - 1)
                    trav, conf = t_s[sid], c_s[sid]
                elif trav_b is not None:
                    trav, conf = trav_b[b], conf_b[b]
                elif prediction_per_pixel:
                    trav, conf = pixelwise_map_rows_chunked(lambda rows: _score_rows(mlp, cg_cfg, cg_state, rows),
                                                            code_hw[b : b + 1], H, W)
                else:
                    t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled)
                    sid = segs[b].long().clamp(0, S - 1)
                    trav, conf = t_s[sid], c_s[sid]
                outs.append(FrameResult(trav, conf, pooled, counts > 0, segs[b], edges, edge_valid, centers))
            return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    def _backbone(imgs: torch.Tensor) -> torch.Tensor:
        """(B, 3, H0, W0) -> the (B, N, 90) codes of the resized frames."""
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        out = stego.vit(imagenet_normalize(resize_image(imgs, H, W)))
        return stego.head(out["patch_tokens"])["code"]

    backbone = StageGraphs(stego.vit, _backbone)

    def _frames(cg_state, imgs, head, stage) -> FrameResult:
        with stage(imgs) as codes:
            return tail(cg_state, codes, head)

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor, head=None, mesh=None) -> FrameResult:
        """(B, 3, H0, W0) -> FrameResult with a leading batch axis."""
        if mesh is not None:
            count("frame.backbone.graph.eager.mesh")
            return dp_split(mesh, lambda x: _frames(cg_state, x, head, backbone.eager), imgs)
        return _frames(cg_state, imgs, head, backbone)

    @torch.no_grad()
    def eager(cg_state: ConfidenceState, imgs: torch.Tensor, head=None) -> FrameResult:
        return _frames(cg_state, imgs, head, backbone.eager)

    def frame(cg_state: ConfidenceState, img: torch.Tensor, head=None) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img, head)))

    frames_batch.backbone = backbone
    frames_batch.eager = eager
    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame


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
    (B, C_i, H_i, W_i) and (B, H, W) segmentations.

    `tvi` is a feature_extractor/torchvision_interface.py::TorchVisionInterface.
    The mode is per segment by construction (the reference's multiscale
    sparsify path): the maps are the per-segment scores gathered over the
    segmentation. Any rectangle works: the convolutions pad."""
    if segmentation_type not in ("slic", "grid"):
        raise ValueError(f"fused torchvision path does not support segmentation [{segmentation_type}]")
    H = input_size
    W = input_width or input_size
    S = num_segments
    model = tvi.model
    default_mlp = mlp
    _segments, _graph = _segmentation(segmentation_type, H, W, S, slic_compactness, slic_iterations, cell_size,
                                      max_edges)

    def _one(mlp, cg_state, pyr_i, seg):
        """Per-image tail: multiscale pooling and scoring over the
        segmentation. pyr_i: {name: (C_i, H_i, W_i)}."""
        edges, edge_valid, centers = _graph(seg)
        pooled, seg_valid = segment_ops.segment_pyramid_pool(pyr_i, seg, S)
        t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled, False, edges, edge_valid)
        sid = seg.long().clamp(0, S - 1)
        return FrameResult(t_s[sid], c_s[sid], pooled, seg_valid, seg, edges, edge_valid, centers)

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, pyramid: dict, segs: torch.Tensor, head=None) -> FrameResult:
        """pyramid {name: (B, C_i, H_i, W_i)}, segs (B, H, W) -> FrameResult
        with a leading batch axis on every field."""
        mlp = default_mlp if head is None else head
        outs = [_one(mlp, cg_state, {k: v[b] for k, v in pyramid.items()}, segs[b]) for b in range(segs.shape[0])]
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor, head=None, mesh=None) -> FrameResult:
        """(B, 3, H0, W0) -> FrameResult with a leading batch axis; the
        pyramid and the segmentation each run once on the batch."""
        if mesh is not None:
            return dp_split(mesh, lambda x: frames_batch(cg_state, x, head), imgs)
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        x = resize_image(imgs, H, W)
        return tail(cg_state, model(imagenet_normalize(x)), _segments(x), head)

    def frame(cg_state: ConfidenceState, img: torch.Tensor, head=None) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img, head)))

    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame


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
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        feat = dense_features(vit, imagenet_normalize(imgs))  # (B, D, Hp, Wp)
        B, D, Hp, Wp = feat.shape
        return mlp(feat.permute(0, 2, 3, 1).reshape(-1, D))[:, 0].reshape(B, Hp, Wp)

    return frames
