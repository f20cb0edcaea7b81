"""WVNRuntime — the single-process online system.

Port of wild_visual_navigation_tpu/runtime/runtime.py. One process runs
the reference's two ROS nodes side by side:

  * the inference path: camera frame -> resize -> DINO ViT (K1) and SLIC
    (K3) or grid segmentation, or ViT-B/8 (K1), the STEGO head and k-means
    clusters, or a ResNet-18 pyramid (cuDNN convolutions) pooled per
    segment over SLIC (K3) or the grid, or dense SIFT / colour histograms
    -> traversability head scored at every pixel (K2 for a SimpleMLP
    head) or per segment -> traversability and confidence maps, plus the
    frame's features into the mission buffer. In anomaly mode the head is
    a LinearRnvp flow and the traversability its calibrated likelihood; a
    graph head (SimpleGCN) scores per segment over the frame's adjacency;
    with `gridmap_size > 0` each frame's maps are also fused into a
    robot-centric grid map (ops/gridmap.py), from which `get_carrot`
    picks the local goal (scripts/smart_carrot.py);
  * the learning path: supervision reprojection (K4) and the train step
    inside the TraversabilityEstimator, on the caller's thread or on the
    learning thread.

The params mailbox. Training updates the estimator's head in place (Adam),
so inference never scores with it: `hot_swap` builds a fresh inference
head from the estimator's snapshot (`state_dict_for_hot_swap`, which
clones) and publishes it under `_mailbox_lock`; a frame takes the
published (head, confidence state) reference once, at its start, and reads
every layer from that one module. A frame therefore never mixes layers of
two swaps, and train steps without a swap leave the maps unchanged, as the
JAX package's pointer swap of an immutable params pytree does.

Both threads enqueue on the device's default stream, so stream order
serialises the supervision flush's buffer writes with the frame's insert;
the estimator's lock orders them on the host. Grad mode is thread-local:
the frame runs under `no_grad` while the learning thread runs autograd.

Under a ("dp", "tp") mesh (`mesh=`, parallel/mesh.py::create_mesh) the
runtime is SPMD: every rank builds the same runtime and makes the same
calls with the same inputs, and every rank keeps the same state. The DINO
backbone is split over tp by head (models/vit.py::shard_heads_),
`image_batch_callback`'s frames over dp, and the estimator splits the
supervision fan-out and the train step's nodes over dp.
`attach_distributed_trainer` joins the learning step to the collective
step of parallel/distributed.py::DistributedTrainer instead.

Not ported yet, and raising NotImplementedError naming its ROADMAP.md
item: int8 backbones and `calibrate_backbone` with them (28).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..cfg.experiment import ExperimentParams
from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from ..feature_extractor.feature_extractor import FeatureExtractor, static_feature_dim, static_num_segments
from ..models.registry import model_needs_edges
from ..ops.gridmap import gridmap_init, gridmap_recenter, project_traversability_to_grid, traversability_sdf
from ..ops.projection import scale_intrinsics
from ..ops.resize import resize_image
from ..scripts.smart_carrot import CarrotConfig, select_carrot
from ..supervision.supervision_generator import SupervisionGenerator
from ..traversability.estimator import TraversabilityEstimator
from ..traversability.mission_buffer import buffer_insert, buffer_insert_batch_impl
from ..traversability.nodes import MissionNode, SupervisionNode
from ..utils.confidence_generator import confidence_load_state_dict
from ..utils.devices import torch_device
from .fused import _score_rows
from .scheduler import Scheduler
from .status import StatusMonitor, SystemEvents


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to torch yet (ROADMAP.md {item})")


class InferenceResult:
    """Per-frame outputs. The maps stay on the device; consumers pull what
    they publish with `to_numpy` (optionally strided and uint8-quantized
    on the device, then one device-to-host copy) at their own rate.

    Batched results are lazy rows: `image_batch_callback` hands each
    camera's result the whole batch's maps, and the row is sliced when
    `.traversability` / `.confidence` is first read."""

    def __init__(self, traversability=None, confidence=None, camera: str = "", stamp: float = 0.0, batch=None):
        self._trav = traversability
        self._conf = confidence
        self.camera = camera
        self.stamp = stamp
        self._batch = batch  # (trav_batch, conf_batch, row) or None

    @property
    def traversability(self):
        if self._trav is None and self._batch is not None:
            self._trav = self._batch[0][self._batch[2]]
        return self._trav

    @property
    def confidence(self):
        if self._conf is None and self._batch is not None and self._batch[1] is not None:
            self._conf = self._batch[1][self._batch[2]]
        return self._conf

    def to_numpy(self, quantize_uint8: bool = False, stride: int = 1):
        """(traversability, confidence) as numpy; striding and uint8
        quantization run on the device, before the one copy to the host."""
        maps = (self.traversability, self.confidence)

        def prep(a):
            if stride > 1:
                a = a[::stride, ::stride]
            if quantize_uint8:
                a = (torch.clamp(a, 0, 1) * 255).to(torch.uint8)
            return a

        present = [prep(a) for a in maps if a is not None]
        if not present:
            return None, None
        host = iter(torch.stack(present).cpu().numpy())
        return tuple(next(host) if a is not None else None for a in maps)


@dataclass
class SystemState:
    """The reference's SystemState message payload
    (wild_visual_navigation_msgs/msg/SystemState.msg)."""

    mode: int = 1
    mission_graph_num_valid_node: int = 0
    step: int = 0
    loss_total: float = -1.0
    loss_trav: float = -1.0
    loss_reco: float = -1.0
    pause_learning: bool = False


class WVNRuntime:
    def __init__(
        self,
        fe_params: Optional[FeatureExtractorNodeParams] = None,
        ln_params: Optional[LearningNodeParams] = None,
        exp_params: Optional[ExperimentParams] = None,
        seed: int = 0,
        anomaly_detection: bool = False,
        buffer_capacity: int = 256,
        reprojection_fanout: int = 32,
        backbone_params=None,
        use_fused: bool = True,
        gridmap_size: int = 0,
        gridmap_resolution: float = 0.1,
        supervision_flush_every: int = 1,
        supervision_resolve_every: int = 1,
        swallow_callback_errors: bool = False,
        score_at_patch_res: bool = False,
        mesh=None,
        build_feature_extractor: bool = True,
        device="cuda",
        backbone_dtype: torch.dtype = torch.bfloat16,
        sampling_seed: Optional[int] = None,
    ):
        """The JAX runtime's arguments, with `seed` (the backbone's weights)
        in place of its `key`, plus `device` (the card unless the caller
        asks for the CPU), `backbone_dtype` (bf16, as the JAX package
        computes; fp32 for parity tests) and `sampling_seed`, the
        estimator's batch-sampling seed (its default when None): a JAX run
        that seeds the global np.random after construction replays with
        that seed here. `backbone_params` is a state dict
        of models/vit.py (utils/params.py::vit_state_from_jax converts a
        JAX one). `mesh`: a ("dp", "tp") DeviceMesh over the ranks that
        run this runtime together (see the module's docstring)."""
        self._device = torch_device(device, "WVNRuntime")
        self.mesh = mesh
        self._dist_trainer = None

        self.fe_params = fe_params or FeatureExtractorNodeParams()
        self.ln_params = ln_params or LearningNodeParams()
        ep = exp_params or ExperimentParams()
        # The node-level confidence_std_factor overrides the experiment's in
        # both loss configs (reference wvn_learning_node.py:196), on a copy.
        sf = self.ln_params.confidence_std_factor
        self.exp_params = dataclasses.replace(
            ep,
            loss=dataclasses.replace(ep.loss, confidence_std_factor=sf),
            loss_anomaly=dataclasses.replace(ep.loss_anomaly, confidence_std_factor=sf),
        )

        fp = self.fe_params
        self._H = fp.network_input_image_height
        self._W = fp.network_input_image_width

        # --- feature extraction (the inference process's half). Without it
        # (the learning node's role) shapes come from the static helpers.
        if build_feature_extractor:
            self.feature_extractor = FeatureExtractor(
                seed=seed,
                segmentation_type=fp.segmentation_type,
                feature_type=fp.feature_type,
                input_size=self._H,
                device=self._device,
                patch_size=fp.dino_patch_size,
                backbone_type=fp.dino_backbone,
                slic_num_components=fp.slic_num_components,
                cell_size=fp.grid_cell_size,
                backbone_params=backbone_params,
                quant=fp.dino_quant,
                dtype=backbone_dtype,
            )
            self._S = self.feature_extractor.num_segments(self._H, self._W)
            self._D = self.feature_extractor.feature_dim
            if mesh is not None and "dino" in fp.feature_type:
                # tensor-parallel backbone: each tp rank keeps its heads and
                # MLP units; one all_reduce after proj and one after fc2
                from ..parallel.mesh import mesh_axis, shard_module, vit_param_spec

                vit = self.feature_extractor._extractor.vit
                shard_module(vit, vit_param_spec(vit, tp=mesh_axis(mesh, "tp")[0]), mesh)
        else:
            self.feature_extractor = None
            use_fused = False
            self._S = static_num_segments(fp.segmentation_type, self._H, self._W, cell_size=fp.grid_cell_size,
                                          slic_num_components=fp.slic_num_components)
            self._D = static_feature_dim(fp.feature_type, fp.dino_backbone)
        # the head's input size comes from the extractor (reference
        # wvn_learning_node.py:309-315)
        model_cfg = self.exp_params.model.to_dict()
        snake = {"SimpleMLP": "simple_mlp_cfg", "DoubleMLP": "double_mlp_cfg",
                 "SimpleGCN": "simple_gcn_cfg", "LinearRnvp": "linear_rnvp_cfg"}[self.exp_params.model.name]
        model_cfg[snake]["input_size"] = self._D

        # --- learning engine (the learning process's half)
        self.estimator = TraversabilityEstimator(
            model_cfg=model_cfg,
            loss_cfg=self.exp_params.loss_cfg(),
            anomaly_loss_cfg=self.exp_params.anomaly_loss_cfg(),
            lr=self.exp_params.optimizer.lr,
            max_distance=self.ln_params.traversability_radius,
            image_distance_thr=self.ln_params.image_graph_dist_thr,
            supervision_distance_thr=self.ln_params.supervision_graph_dist_thr,
            min_samples_for_training=self.ln_params.min_samples_for_training,
            batch_size=self.exp_params.ablation_data_module.batch_size,
            mode=self.ln_params.mode,
            extraction_store_folder=self.ln_params.extraction_store_folder,
            anomaly_detection=anomaly_detection,
            buffer_capacity=buffer_capacity,
            num_segments=self._S,
            feature_dim=self._D,
            image_height=self._H,
            image_width=self._W,
            max_edges=self.feature_extractor._max_edges if self.feature_extractor is not None else 1024,
            reprojection_fanout=reprojection_fanout,
            vis_node_index=self.ln_params.vis_node_index,
            supervision_flush_every=supervision_flush_every,
            supervision_resolve_every=supervision_resolve_every,
            sampling_seed=sampling_seed,
            mesh=mesh,
            device=self._device,
        )
        self.supervision_generator = SupervisionGenerator(untraversable_thr=self.ln_params.untraversable_thr)

        # --- camera arbitration (reference scheduler + rate gates)
        self.scheduler = Scheduler()
        for cam, cfg in self.fe_params.camera_topics.items():
            self.scheduler.add_process(cam, int(cfg.get("scheduler_weight", 1)))
        self._last_image_ts: Dict[str, float] = {}
        self._last_supervision_ts: Optional[float] = None
        self._unknown_cameras: set = set()
        self._K_cache: dict = {}

        # --- params mailbox: a head no training step touches
        self._mailbox_lock = threading.Lock()
        self._head_template = copy.deepcopy(self.estimator.model).eval().requires_grad_(False)
        self._last_swap_step = -1
        self.hot_swaps = 0
        self.hot_swap()
        self.hot_swaps = 0

        # --- the optional rolling grid map (the consumer-side fusion that
        # elevation_mapping_cupy performs for the reference), on this device
        self.gridmap = None
        self._gridmap_resolution = gridmap_resolution
        if gridmap_size > 0:
            self.gridmap = gridmap_init(size=gridmap_size, resolution=gridmap_resolution, device=self._device)
        self.system_state = SystemState()
        self.anomaly_detection = anomaly_detection
        self._stop_event = threading.Event()
        self._learning_thread: Optional[threading.Thread] = None
        # per-callback event journal + failure containment (reference
        # _system_events, wvn_learning_node.py:446-457)
        self.events = SystemEvents()
        self._swallow_errors = swallow_callback_errors
        self._deferred_shutdown = None
        # input-freshness table (reference status thread)
        self.status = StatusMonitor(printer=None)

        # Fused frame path (runtime/fused.py): dino backbones with slic or
        # grid segmentation (anomaly mode too), stego x stego, and the
        # torchvision pyramids with slic or grid; 'none' (pixel-wise) goes
        # composed. The CNN pyramids pad, so any rectangle fuses.
        self._fused_frame = None
        dino_fusable = "dino" in fp.feature_type and fp.segmentation_type in ("slic", "grid")
        stego_fusable = fp.feature_type == "stego" and fp.segmentation_type == "stego" and not anomaly_detection
        tv_fusable = (fp.feature_type == "torchvision" and fp.segmentation_type in ("slic", "grid")
                      and not anomaly_detection)
        if use_fused and self._W != self._H:
            ps = self.feature_extractor._extractor.vit.cfg.patch_size if dino_fusable or stego_fusable else 1
            if self._H % ps or self._W % ps:
                warnings.warn(f"fused {fp.feature_type} path requires a square or patch-aligned input "
                              f"({self._H}x{self._W} configured, patch {ps}) — using the composed path", stacklevel=2)
                use_fused = False
        if use_fused and dino_fusable:
            from .fused import build_fused_frame_fn

            fe = self.feature_extractor
            self._fused_frame = build_fused_frame_fn(
                fe._extractor.vit,
                self.estimator.model,
                self.estimator._cg_cfg,
                input_size=self._H,
                segmentation_type=fp.segmentation_type,
                num_segments=self._S,
                slic_compactness=fe._slic_compactness,
                cell_size=fe._cell_size,
                max_edges=fe._max_edges,
                prediction_per_pixel=fp.prediction_per_pixel,
                score_at_patch_res=score_at_patch_res,
                input_width=self._W,
                anomaly=anomaly_detection,
            )
        elif use_fused and stego_fusable:
            from .fused import build_fused_stego_frame_fn

            self._fused_frame = build_fused_stego_frame_fn(
                self.feature_extractor._extractor,
                self.estimator.model,
                self.estimator._cg_cfg,
                input_size=self._H,
                max_edges=self.feature_extractor._max_edges,
                prediction_per_pixel=fp.prediction_per_pixel,
                input_width=self._W,
            )
        elif use_fused and tv_fusable:
            from .fused import build_fused_torchvision_frame_fn

            fe = self.feature_extractor
            self._fused_frame = build_fused_torchvision_frame_fn(
                fe._extractor,
                self.estimator.model,
                self.estimator._cg_cfg,
                input_size=self._H,
                segmentation_type=fp.segmentation_type,
                num_segments=self._S,
                slic_compactness=fe._slic_compactness,
                cell_size=fe._cell_size,
                max_edges=fe._max_edges,
                input_width=self._W,
            )

    # ----------------------------------------------------------- mailbox
    @property
    def inference_head(self):
        """The published head and confidence state, read as a frame reads them."""
        with self._mailbox_lock:
            return self._inference_head, self._inference_cg

    def hot_swap(self):
        """Publish the learner's params to the inference mailbox: a new
        head built from the estimator's snapshot, swapped in whole. With a
        distributed trainer attached, its params are written into the
        estimator first (a collective when its tp > 1)."""
        if self._dist_trainer is not None:
            self._dist_trainer.sync_to_estimator()
        with self.estimator.lock:
            snap = self.estimator.state_dict_for_hot_swap()
            cg = confidence_load_state_dict(self.estimator.confidence_state, snap["confidence_generator"])
        head = copy.deepcopy(self._head_template)
        head.load_state_dict(snap["params"], assign=True)
        head.requires_grad_(False)
        with self._mailbox_lock:
            self._inference_head, self._inference_cg = head, cg
            self.hot_swaps += 1

    def adopt_train_state(self, params: dict, adam: Optional[dict], cg_state, step: Optional[int] = None):
        """Hand a carried training state (utils/params.py::train_state_from_jax)
        to the estimator, then publish it to inference."""
        self.estimator.adopt_train_state(params, adam, cg_state, step)
        self.hot_swap()

    # --------------------------------------------------------- inference
    def calibrate_backbone(self, sample_batches) -> bool:
        """No-op returning False: the port's backbones are not quantized."""
        if self.fe_params.dino_quant is not None:
            raise _not_ported(f"backbone quantization [{self.fe_params.dino_quant}]", "Queue 1, item 28")
        return False

    def _to_device(self, img) -> torch.Tensor:
        """Upload a host frame as it is (uint8 stays uint8: the frame
        converts it on the device)."""
        t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self._device)

    def _scale_K_cached(self, Ks: np.ndarray, orig_h: int, orig_w: int) -> torch.Tensor:
        """Intrinsics are static per mission: rescaled once per value and
        kept on the device."""
        Kn = np.ascontiguousarray(Ks)
        key = (Kn.tobytes(), Kn.shape, orig_h, orig_w)
        hit = self._K_cache.get(key)
        if hit is None:
            if len(self._K_cache) > 64:
                self._K_cache.clear()
            hit = self._K_cache[key] = scale_intrinsics(
                Kn, orig_h, orig_w, new_h=self._H, new_w=None if self._W == self._H else self._W).to(self._device)
        return hit

    def _scale_K(self, K, orig_h: int, orig_w: int) -> torch.Tensor:
        return self._scale_K_cached(np.asarray(K)[None], orig_h, orig_w)[0]

    def _make_mission_node(self, stamp, camera, pose_base_in_world, pose_cam_in_base) -> MissionNode:
        return MissionNode(
            timestamp=float(stamp),
            pose_base_in_world=np.asarray(pose_base_in_world, dtype=np.float64),
            pose_cam_in_base=np.asarray(pose_cam_in_base, dtype=np.float64),
            camera_name=camera,
            use_for_training=bool(self.fe_params.camera_topics.get(camera, {}).get("use_for_training", True)),
        )

    def _score(self, head, cg, x: torch.Tensor, edges=None, edge_valid=None):
        """(N, D) rows -> (trav (N,), conf (N,)); in anomaly mode the
        traversability is the calibrated flow likelihood and conf is 1."""
        return _score_rows(head, self.estimator._cg_cfg, cg, x, self.anomaly_detection, edges, edge_valid)

    @torch.no_grad()
    def _predict_dense(self, head, cg, dense_feat: torch.Tensor):
        """(D, H, W) -> per-pixel traversability and confidence (None in
        anomaly mode, as the JAX runtime returns)."""
        D, H, W = dense_feat.shape
        trav, conf = self._score(head, cg, dense_feat.reshape(D, -1).T.float())
        return trav.reshape(H, W), None if self.anomaly_detection else conf.reshape(H, W)

    @torch.no_grad()
    def _predict_segments(self, head, cg, feat: torch.Tensor, seg: torch.Tensor, edges=None, edge_valid=None):
        """(S, D) pooled features + (H, W) seg -> per-pixel maps through
        the segment ids (the reference's per-segment scoring). Graph heads
        also take the frame's segment adjacency."""
        trav_seg, conf_seg = self._score(head, cg, feat.float(), edges, edge_valid)
        sid = seg.long().clamp(0, self._S - 1)
        return trav_seg[sid], conf_seg[sid]

    def image_callback(self, img, stamp: float, camera: str, K: np.ndarray, orig_h: int, orig_w: int,
                       pose_base_in_world: np.ndarray, pose_cam_in_base: np.ndarray,
                       prediction_per_pixel: Optional[bool] = None) -> Optional[InferenceResult]:
        """Per-frame path (reference wvn_feature_extractor_node.py:273-405
        and the learning node's imagefeat_callback; one process, so the
        features go straight into the mission buffer).

        img: (3, H0, W0) RGB, numpy or torch, float in [0, 1] or uint8.
        Returns None when rate-gated or scheduled out."""
        self.events.record("image_callback_received")
        self.status.tick(f"camera:{camera}")
        # a camera the scheduler does not know would be dropped forever
        if self.fe_params.camera_topics and camera not in self.fe_params.camera_topics \
                and camera not in self._unknown_cameras:
            self._unknown_cameras.add(camera)
            warnings.warn(f"image_callback: camera '{camera}' is not in camera_topics "
                          f"{sorted(self.fe_params.camera_topics)} — every frame from it will be dropped by the "
                          f"scheduler", stacklevel=2)
        last = self._last_image_ts.get(camera)
        if last is not None and (stamp - last) < 1.0 / self.fe_params.image_callback_rate:
            self.events.record("image_callback_canceled", "canceled due to rate")
            return None
        if self.scheduler.get() != camera:
            self.scheduler.step()
            self.events.record("image_callback_canceled", "canceled due to scheduler")
            return None
        self.scheduler.step()
        self._last_image_ts[camera] = stamp
        try:
            return self._image_callback_body(img, stamp, camera, K, orig_h, orig_w, pose_base_in_world,
                                             pose_cam_in_base, prediction_per_pixel)
        except Exception as exc:
            self.events.record_error("image_callback_state", exc)
            if not self._swallow_errors:
                raise
            return None
        finally:
            self._finish_deferred_shutdown()

    def _image_callback_body(self, img, stamp, camera, K, orig_h, orig_w, pose_base_in_world, pose_cam_in_base,
                             prediction_per_pixel) -> InferenceResult:
        if self.feature_extractor is None:
            raise RuntimeError("this runtime was built with build_feature_extractor=False (learning-process role) "
                               "— it ingests pre-extracted features, not camera frames")
        if prediction_per_pixel is None:
            prediction_per_pixel = self.fe_params.prediction_per_pixel
        x = self._to_device(img)[None]  # (1, 3, H0, W0)
        head, cg = self.inference_head  # one reference for the whole frame
        K_scaled = self._scale_K(K, orig_h, orig_w)
        node = self._make_mission_node(stamp, camera, pose_base_in_world, pose_cam_in_base)

        if self._fused_frame is not None and prediction_per_pixel == self.fe_params.prediction_per_pixel:
            fr = self._fused_frame(cg, x, head)
            # graph gate, slot and in-place insert in one critical section:
            # the learning thread's flush and gather take the same lock
            with self.estimator.lock:
                slot = self.estimator.allocate_slot(node)
                if slot is not None:
                    buffer_insert(self.estimator.buffer, slot, fr.features, fr.feat_valid, fr.segments, K_scaled,
                                  node.pose_cam_in_world)
            if self.gridmap is not None:
                self._update_gridmap(fr.traversability, fr.confidence, K_scaled, node.pose_cam_in_world,
                                     node.pose_base_in_world)
            return InferenceResult(traversability=fr.traversability, confidence=fr.confidence, camera=camera,
                                   stamp=stamp)

        img_r = resize_image(x, self._H, self._W if self._W != self._H else None)
        ex = self.feature_extractor.extract(img_r, return_dense_features=prediction_per_pixel)
        if model_needs_edges(head):
            # graph heads score per segment over the frame's adjacency
            trav, conf = self._predict_segments(head, cg, ex.features, ex.segments, ex.edges, ex.edge_valid)
        elif prediction_per_pixel and ex.dense_features is not None:
            trav, conf = self._predict_dense(head, cg, ex.dense_features)
        else:
            trav, conf = self._predict_segments(head, cg, ex.features, ex.segments)
        if ex.features is not None and ex.features.shape[0] == self._S:
            feat_valid = ex.center_valid if ex.center_valid.shape[0] == ex.features.shape[0] else \
                torch.ones((self._S,), dtype=torch.bool, device=self._device)
            self.estimator.add_mission_node(node, ex.features, feat_valid, ex.segments, K_scaled)
        if self.gridmap is not None and conf is not None:
            self._update_gridmap(trav, conf, K_scaled, node.pose_cam_in_world, node.pose_base_in_world)
        return InferenceResult(traversability=trav, confidence=conf, camera=camera, stamp=stamp)

    def image_batch_callback(self, imgs, stamps, cameras, Ks: np.ndarray, orig_h: int, orig_w: int,
                             poses_base_in_world: np.ndarray, poses_cam_in_base: np.ndarray):
        """Multi-camera batched path: all B cameras' frames through one
        `frames_batch` (the backbone, SLIC or k-means, and K2 each once on the batch),
        then the B-row buffer insert. No rate gate or scheduler: the caller
        batches synchronized frames. Returns one InferenceResult per camera.

        imgs: (B, 3, H0, W0); Ks: (B, 3, 3); poses: (B, 4, 4)."""
        if self._fused_frame is None:
            raise ValueError("image_batch_callback requires the fused path (use_fused=True; dino or torchvision "
                             "with slic or grid, or stego x stego)")
        self.events.record("image_batch_callback_received")
        for i, cam in enumerate(cameras):
            self.status.tick(f"camera:{cam}")
            # mixing the single and batched paths for one camera must not
            # process a frame twice
            self._last_image_ts[cam] = float(stamps[i])
        try:
            return self._image_batch_callback_body(imgs, stamps, cameras, Ks, orig_h, orig_w, poses_base_in_world,
                                                   poses_cam_in_base)
        except Exception as exc:
            self.events.record_error("image_batch_callback_state", exc)
            if not self._swallow_errors:
                raise
            return []
        finally:
            self._finish_deferred_shutdown()

    def _image_batch_callback_body(self, imgs, stamps, cameras, Ks, orig_h, orig_w, poses_base_in_world,
                                   poses_cam_in_base):
        B = imgs.shape[0]
        x = self._to_device(imgs)
        head, cg = self.inference_head
        K_scaled = self._scale_K_cached(np.asarray(Ks), orig_h, orig_w)
        nodes = [self._make_mission_node(stamps[i], cameras[i], poses_base_in_world[i], poses_cam_in_base[i])
                 for i in range(B)]
        fr = self._fused_frame.frames_batch(cg, x, head, mesh=self.mesh)
        # slots are reserved on the host; gated and non-training cameras get
        # slot == capacity, a row the insert drops on the host
        with self.estimator.lock:
            slots = np.full((B,), self.estimator.buffer.capacity, np.int64)
            for i, node in enumerate(nodes):
                s = self.estimator.allocate_slot(node)
                if s is not None:
                    slots[i] = s
            buffer_insert_batch_impl(self.estimator.buffer, slots, fr.features, fr.feat_valid, fr.segments, K_scaled,
                                     np.stack([n.pose_cam_in_world for n in nodes]))
        if self.gridmap is not None:
            for i, node in enumerate(nodes):
                self._update_gridmap(fr.traversability[i], fr.confidence[i], K_scaled[i], node.pose_cam_in_world,
                                     node.pose_base_in_world)
        return [InferenceResult(camera=node.camera_name, stamp=float(stamps[i]),
                                batch=(fr.traversability, fr.confidence, i)) for i, node in enumerate(nodes)]

    # ------------------------------------------------------- supervision
    def robot_state_callback(self, stamp: float, pose_base_in_world: np.ndarray, current_twist: np.ndarray,
                             desired_twist: np.ndarray, pose_footprint_in_base: Optional[np.ndarray] = None) -> bool:
        """Proprioception path (reference wvn_learning_node.py:435-548)."""
        self.events.record("robot_state_callback_received")
        self.status.tick("robot_state")
        if (self._last_supervision_ts is not None
                and (stamp - self._last_supervision_ts) < 1.0 / self.ln_params.supervision_callback_rate):
            self.events.record("robot_state_callback_canceled", "canceled due to rate")
            return False
        self._last_supervision_ts = stamp
        try:
            return self._robot_state_callback_body(stamp, pose_base_in_world, current_twist, desired_twist,
                                                   pose_footprint_in_base)
        except Exception as exc:
            self.events.record_error("robot_state_callback_state", exc)
            if not self._swallow_errors:
                raise
            return False
        finally:
            self._finish_deferred_shutdown()

    def _robot_state_callback_body(self, stamp, pose_base_in_world, current_twist, desired_twist,
                                   pose_footprint_in_base) -> bool:
        trav, var, untrav = self.supervision_generator.update_velocity_tracking(
            np.asarray(current_twist), np.asarray(desired_twist), max_velocity=0.8, velocities=["vx", "vy"])
        node = SupervisionNode(
            timestamp=stamp,
            pose_base_in_world=np.asarray(pose_base_in_world, dtype=np.float64),
            pose_footprint_in_base=(np.eye(4) if pose_footprint_in_base is None
                                    else np.asarray(pose_footprint_in_base, dtype=np.float64)),
            twist_in_base=np.asarray(current_twist, dtype=np.float64),
            desired_twist_in_base=np.asarray(desired_twist, dtype=np.float64),
            length=self.ln_params.robot_length,
            width=self.ln_params.robot_width,
            height=self.ln_params.robot_height,
            traversability=trav,
            traversability_var=var,
            is_untraversable=untrav,
        )
        return self.estimator.add_supervision_node(node)

    # ---------------------------------------------------------- learning
    def attach_distributed_trainer(self, trainer=None, tp: int = 1):
        """Multi-process mode (parallel/distributed.py): learning_step joins
        the collective global train step instead of stepping the local
        estimator, so every process's runtime must call learning_step at
        the same cadence. Pass a DistributedTrainer, or None to build one
        over the global mesh (tp > 1: a ("dp", "tp") mesh with the head's
        linear layers split over tp). Ingestion (camera callbacks,
        supervision) stays local to the process."""
        if trainer is None:
            from ..parallel.distributed import DistributedTrainer

            trainer = DistributedTrainer(self.estimator, tp=tp)
        self._dist_trainer = trainer
        return trainer

    def learning_step(self) -> SystemState:
        """One tick of the learning loop (reference learning_thread_loop,
        wvn_learning_node.py:344-408): train step, SystemState update, hot
        swap at the checkpoint rate. Losses are read back from the device
        only at the logging cadence (`logging_thread_rate`). With a
        distributed trainer the step is its collective step; a pause binds
        there too (an operator pauses every process)."""
        log_every = max(1, int(self.ln_params.learning_thread_rate / max(self.ln_params.logging_thread_rate, 1e-9)))
        trainer = self._dist_trainer
        # the cadence follows the counter that advances per tick: the
        # estimator's step stands still between hot swaps in distributed mode
        convert = ((trainer.step_count if trainer is not None else self.estimator.step) % log_every) == 0
        try:
            if trainer is not None:
                res = {} if self.estimator.pause_learning else trainer.step()
            else:
                res = self.estimator.train(convert_losses=convert)
            # train() returns {} when paused: report the real graph all the same
            res.setdefault("mission_graph_num_valid_node", self.estimator._mission_graph.get_num_valid_nodes())
        except Exception as exc:
            self.events.record_error("learning_step_state", exc)
            if not self._swallow_errors:
                raise
            return self.system_state
        finally:
            self._finish_deferred_shutdown()
        st = self.system_state
        st.mission_graph_num_valid_node = res.get("mission_graph_num_valid_node", 0)
        cur_step = trainer.step_count if trainer is not None else self.estimator.step
        st.step = cur_step
        # losses only from ticks that produced values (-1 when data-starved
        # is a value); a paused tick keeps the carried readout
        if convert and "loss_total" in res:
            st.loss_total = float(res["loss_total"])
            st.loss_trav = float(res.get("loss_trav", -1.0))
            st.loss_reco = float(res.get("loss_reco", -1.0))
        st.pause_learning = self.estimator.pause_learning

        swap_every = max(1, int(self.ln_params.learning_thread_rate / self.ln_params.load_save_checkpoint_rate))
        if cur_step != self._last_swap_step and cur_step % swap_every == 0:
            self.hot_swap()
            self._last_swap_step = cur_step
        return st

    def _update_gridmap(self, trav, conf, K_scaled, pose_cam_in_world, pose_base_in_world):
        """Recentre the grid on the robot's xy, then fuse the frame's maps
        with the confidence as weight."""
        grid = gridmap_recenter(self.gridmap, np.asarray(pose_base_in_world)[:2, 3])
        self.gridmap = project_traversability_to_grid(grid, trav, K_scaled, pose_cam_in_world, confidence=conf)

    def get_carrot(self, yaw: float = 0.0):
        """Local goal from the fused grid map (the smart_carrot consumer):
        ((world_x, world_y), score_map), (None, score_map) when no cell
        qualifies, or (None, None) without a grid map. The SDF is computed
        on the device and copied to the host once, with the valid mask."""
        if self.gridmap is None:
            return None, None
        gm = self.gridmap
        sdf = traversability_sdf(gm.traversability, gm.valid, resolution=self._gridmap_resolution)
        sdf_h, valid_h = torch.stack([sdf, gm.valid.float()]).cpu().numpy()
        cell, score = select_carrot(sdf_h, yaw=yaw, valid=valid_h > 0, cfg=CarrotConfig())
        if cell is None:
            return None, score
        world = gm.origin_xy + (np.array([cell[1], cell[0]]) + 0.5) * self._gridmap_resolution
        return (float(world[0]), float(world[1])), score

    def start_learning_thread(self):
        def loop():
            period = 1.0 / self.ln_params.learning_thread_rate
            while not self._stop_event.is_set():
                t0 = time.time()
                self.learning_step()
                dt = time.time() - t0
                if dt < period:
                    self._stop_event.wait(period - dt)

        self._stop_event.clear()
        self._learning_thread = threading.Thread(target=loop, daemon=True, name="wvn-learning")
        self._learning_thread.start()

    def stop_learning_thread(self):
        self._stop_event.set()
        if self._learning_thread is not None:
            self._learning_thread.join(timeout=5.0)
            self._learning_thread = None

    # ---------------------------------------------------------- services
    def save_checkpoint(self, path: str, name: str = "last_checkpoint.ckpt") -> str:
        return self.estimator.save_checkpoint(path, name)

    def load_checkpoint(self, path: str):
        self.estimator.load_checkpoint(path)
        self.hot_swap()

    def pause_learning(self, pause: bool):
        self.estimator.pause_learning = pause

    def export_supervision_markers(self, ply_path: Optional[str] = None, json_path: Optional[str] = None):
        """The driven-footprint ribbon and collision walls as a
        visu/markers.py::TriangleList, written as PLY and / or JSON when
        paths are given (the reference's RViz footprint markers)."""
        from ..visu import export_supervision_markers

        return export_supervision_markers(self.estimator.get_supervision_nodes(), ply_path=ply_path,
                                          json_path=json_path)

    def reset(self):
        self.estimator.reset()
        self.hot_swap()

    # ---------------------------------------------------------- shutdown
    def shutdown(self, mission_path: Optional[str] = None,
                 checkpoint_name: str = "last_checkpoint.ckpt") -> Optional[str]:
        """Graceful shutdown (reference shutdown_callback,
        wvn_learning_node.py:148-174): stop the learning thread, flush
        pending supervision, persist a final mission checkpoint, and dump
        the system-events journal next to it. Returns the checkpoint path
        (None if no mission_path given)."""
        self.stop_learning_thread()
        self.estimator.flush_supervision()
        path = None
        if mission_path is not None:
            path = self.estimator.save_checkpoint(mission_path, checkpoint_name)
            self.events.record("shutdown", f"checkpoint stored at {path}")
            self.events.dump(os.path.join(mission_path, "system_events.json"))
        return path

    def install_signal_handlers(self, mission_path: str):
        """SIGINT/SIGTERM persist a final checkpoint before exiting. Call
        from the main thread. A signal that lands while the interrupted
        callback holds the estimator's lock defers the shutdown to that
        callback's epilogue."""
        import signal

        def _handler(signum, frame):
            if getattr(self.estimator.lock, "held_by_current_thread", True):
                self._deferred_shutdown = (mission_path, signum)
                return
            self.shutdown(mission_path)
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)

        self._deferred_shutdown = None
        signal.signal(signal.SIGINT, _handler)
        signal.signal(signal.SIGTERM, _handler)

    def _finish_deferred_shutdown(self):
        """Complete a shutdown deferred by the signal handler; main thread
        only (signal handlers fire there, and the learning thread must not
        join itself)."""
        if threading.current_thread() is not threading.main_thread():
            return
        req = self._deferred_shutdown
        if req is None:
            return
        import signal

        mission_path, signum = req
        self._deferred_shutdown = None
        self.shutdown(mission_path)
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
