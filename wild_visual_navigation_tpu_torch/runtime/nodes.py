"""Process-separated deployment: the two-node topology of the reference.

Port of wild_visual_navigation_tpu/runtime/nodes.py:

  * FeatureExtractorNode (reference wvn_feature_extractor_node.py:37-464):
    camera frames in -> traversability and confidence out, ImageFeatures
    published over a transport; polls the hot-swap file at
    `load_save_checkpoint_rate` and reloads when the learner's step moved.
    Its frames run the backbone (K1) and, through the facade, SLIC (K3);
    the head scores the dense features with plain torch matmuls, as the
    JAX node scores them with a jitted MLP (K2 is the fused runtime's).
  * LearningNode (reference wvn_learning_node.py:51-966): RobotState and
    ImageFeatures in -> supervision graph and training (a WVNRuntime with
    no feature extractor); writes the hot-swap file atomically and serves
    checkpoint requests.

The hot-swap file is torch's own format (`torch.save` to a temporary
file, then `os.replace`) under a name of its own, so a JAX node and a port
node never read each other's file. The ImageFeatures wire format is the
JAX package's, byte for byte (msgs.py is a copy): a JAX FeatureExtractorNode
can feed a port LearningNode.

Both are pump-style objects (explicit calls per message) so tests, a
replay or a ROS shim can drive them.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..cfg.experiment import ExperimentParams
from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from ..feature_extractor.feature_extractor import FeatureExtractor
from ..models.registry import get_model
from ..ops.projection import scale_intrinsics
from ..ops.resize import resize_image
from ..traversability.nodes import MissionNode
from ..utils.confidence_generator import ConfidenceConfig, confidence_init, confidence_load_state_dict
from .fused import _score_rows
from .msgs import ImageFeatures, SystemStateMsg
from .runtime import WVNRuntime
from .scheduler import Scheduler

HOT_SWAP_FILENAME = ".tmp_state_dict_torch.pt"


def write_hot_swap_state(folder: str, params: dict, cg_state_dict: dict, step: int) -> str:
    """Atomic write (temporary file, then rename) of the hot-swap payload:
    the head's state dict, the confidence statistics and the step, on the
    CPU (the reference's `.tmp_state_dict.pt`, wvn_learning_node.py:382-394)."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, HOT_SWAP_FILENAME)
    tmp = path + ".writing"
    torch.save({
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "confidence_generator": {k: torch.as_tensor(v).detach().cpu() for k, v in cg_state_dict.items()},
        "step": int(step),
    }, tmp)
    os.replace(tmp, path)
    return path


def read_hot_swap_state(folder: str, map_location=None):
    """(params, confidence dict, step) from the hot-swap file, or None."""
    path = os.path.join(folder, HOT_SWAP_FILENAME)
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["params"], payload["confidence_generator"], payload["step"]


class FeatureExtractorNode:
    """Inference-process node. Wire `publish_features` to a transport
    publisher; call `image_callback` per camera frame; call
    `maybe_reload_weights` at the checkpoint rate."""

    def __init__(
        self,
        params: Optional[FeatureExtractorNodeParams] = None,
        exp_params: Optional[ExperimentParams] = None,
        hot_swap_folder: str = "/tmp/wvn_mission",
        publish_features: Optional[Callable[[bytes], None]] = None,
        seed: int = 0,
        backbone_params=None,
        device="cuda",
        backbone_dtype: torch.dtype = torch.bfloat16,
    ):
        self.params = params or FeatureExtractorNodeParams()
        self.exp = exp_params or ExperimentParams()
        self._hot_swap_folder = hot_swap_folder
        self._publish_features = publish_features
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FeatureExtractorNode: no CUDA device; pass device='cpu' to run on the CPU")

        p = self.params
        self._H, self._W = p.network_input_image_height, p.network_input_image_width
        self.feature_extractor = FeatureExtractor(
            seed=seed,
            segmentation_type=p.segmentation_type,
            feature_type=p.feature_type,
            input_size=self._H,
            device=self._device,
            patch_size=p.dino_patch_size,
            backbone_type=p.dino_backbone,
            slic_num_components=p.slic_num_components,
            cell_size=p.grid_cell_size,
            backbone_params=backbone_params,
            quant=p.dino_quant,
            dtype=backbone_dtype,
        )
        D = self.feature_extractor.feature_dim
        self._S = self.feature_extractor.num_segments(self._H, self._W)
        model_name = self.exp.model.name
        if model_name == "SimpleGCN":
            # ImageFeatures carries no edges; the GCN needs the single-process runtime
            raise ValueError("FeatureExtractorNode does not support SimpleGCN (no edge transport in ImageFeatures); "
                             "use WVNRuntime instead.")
        snake = {"SimpleMLP": "simple_mlp_cfg", "DoubleMLP": "double_mlp_cfg", "LinearRnvp": "linear_rnvp_cfg"}
        self._anomaly = model_name == "LinearRnvp"
        model_cfg = self.exp.model.to_dict()
        model_cfg[snake[model_name]]["input_size"] = D
        self.model = get_model(model_cfg, device=self._device, generator=torch.Generator().manual_seed(seed + 7))
        self.model.eval().requires_grad_(False)
        self.cg_state = confidence_init(self._device)
        self.cg_cfg = ConfidenceConfig(std_factor=p.confidence_std_factor)
        self._loaded_step = -1
        self.scheduler = Scheduler()
        for cam, cfg in p.camera_topics.items():
            self.scheduler.add_process(cam, int(cfg.get("scheduler_weight", 1)))
        self._last_ts: Dict[str, float] = {}

    def _score(self, x: torch.Tensor):
        """(N, D) features -> (N,) trav, (N,) confidence. A LinearRnvp
        head (anomaly mode) scores the calibrated flow likelihood, with
        confidence 1."""
        return _score_rows(self.model, self.cg_cfg, self.cg_state, x, self._anomaly)

    def maybe_reload_weights(self) -> bool:
        """Poll the hot-swap file; reload when the learner's step moved
        (reference load_model, wvn_feature_extractor_node.py:407-450)."""
        out = read_hot_swap_state(self._hot_swap_folder, map_location=self._device)
        if out is None:
            return False
        params, cg_dict, step = out
        if step == self._loaded_step:
            return False
        self.model.load_state_dict(params)
        self.cg_state = confidence_load_state_dict(self.cg_state, cg_dict)
        self._loaded_step = step
        return True

    @torch.no_grad()
    def image_callback(self, img, stamp: float, camera: str, K, orig_h: int, orig_w: int,
                       pose_base_in_world=None, pose_cam_in_base=None):
        last = self._last_ts.get(camera)
        if last is not None and (stamp - last) < 1.0 / self.params.image_callback_rate:
            return None
        if self.scheduler.get() != camera:
            self.scheduler.step()
            return None
        self.scheduler.step()
        self._last_ts[camera] = stamp

        x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
        x = (x.float() if x.dtype == torch.float64 else x).to(self._device)[None]
        img_r = resize_image(x, self._H, None if self._H == self._W else self._W)
        ex = self.feature_extractor.extract(img_r, return_dense_features=self.params.prediction_per_pixel)
        if self.params.prediction_per_pixel and ex.dense_features is not None:
            Dd, Hh, Ww = ex.dense_features.shape
            trav, conf = self._score(ex.dense_features.reshape(Dd, -1).T.float())
            trav, conf = trav.reshape(Hh, Ww), conf.reshape(Hh, Ww)
        else:
            t_s, c_s = self._score(ex.features.float())
            sid = ex.segments.long().clamp(0, ex.features.shape[0] - 1)
            trav, conf = t_s[sid], c_s[sid]

        if self._publish_features is not None and ex.features is not None:
            # new_w matters for rectangles: the square branch would ship
            # fy / cy in the fx / cx slots
            K_scaled = scale_intrinsics(np.asarray(K)[None], orig_h, orig_w, new_h=self._H,
                                        new_w=None if self._W == self._H else self._W)[0]
            n = ex.features.shape[0]
            msg = ImageFeatures(
                stamp=stamp,
                camera=camera,
                segments=ex.segments.to(torch.int32).cpu().numpy(),
                features=ex.features.float().cpu().numpy(),
                feat_valid=ex.center_valid.cpu().numpy() if ex.center_valid.shape[0] == n else np.ones(n, bool),
                K_scaled=K_scaled.numpy(),
                pose_base_in_world=np.asarray(pose_base_in_world if pose_base_in_world is not None else np.eye(4)),
                pose_cam_in_base=np.asarray(pose_cam_in_base if pose_cam_in_base is not None else np.eye(4)),
            )
            self._publish_features(msg.pack())
        maps = torch.stack([trav, conf]).cpu().numpy()
        return maps[0], maps[1]


class LearningNode:
    """Learning-process node: WVNRuntime's estimator side, fed by
    transports, emitting the hot-swap file and SystemState."""

    def __init__(
        self,
        fe_params: Optional[FeatureExtractorNodeParams] = None,
        ln_params: Optional[LearningNodeParams] = None,
        exp_params: Optional[ExperimentParams] = None,
        hot_swap_folder: str = "/tmp/wvn_mission",
        publish_system_state: Optional[Callable[[bytes], None]] = None,
        seed: int = 0,
        device="cuda",
    ):
        # the runtime without a feature extractor: features arrive as
        # ImageFeatures, and a resident backbone would be dead weight
        self.runtime = WVNRuntime(fe_params=fe_params, ln_params=ln_params, exp_params=exp_params, seed=seed,
                                  build_feature_extractor=False, device=device)
        self._hot_swap_folder = hot_swap_folder
        self._publish_system_state = publish_system_state
        self._last_saved_step = -1
        # startup: delete a stale hot-swap file (reference wvn_learning_node.py:953-955)
        stale = os.path.join(hot_swap_folder, HOT_SWAP_FILENAME)
        if os.path.exists(stale):
            os.unlink(stale)

    def imagefeat_callback(self, payload: bytes) -> bool:
        """Deserialize ImageFeatures and insert the mission node
        (reference imagefeat_callback, wvn_learning_node.py:550-688)."""
        msg = ImageFeatures.unpack(payload)
        node = MissionNode(
            timestamp=msg.stamp,
            pose_base_in_world=msg.pose_base_in_world,
            pose_cam_in_base=msg.pose_cam_in_base,
            camera_name=msg.camera,
            # use_for_training=False cameras stay out of the training buffer here too
            use_for_training=self.runtime.fe_params.camera_topics.get(msg.camera, {}).get("use_for_training", True),
        )
        return self.runtime.estimator.add_mission_node(node, msg.features, msg.feat_valid, msg.segments, msg.K_scaled)

    def robot_state_callback(self, stamp, pose_base_in_world, current_twist, desired_twist) -> bool:
        return self.runtime.robot_state_callback(stamp, pose_base_in_world, current_twist, desired_twist)

    def _write_hot_swap(self) -> str:
        snap = self.runtime.estimator.state_dict_for_hot_swap()
        return write_hot_swap_state(self._hot_swap_folder, snap["params"], snap["confidence_generator"], snap["step"])

    def learning_step(self):
        st = self.runtime.learning_step()
        est = self.runtime.estimator
        ln = self.runtime.ln_params
        swap_every = max(1, int(ln.learning_thread_rate / ln.load_save_checkpoint_rate))
        if est.step != self._last_saved_step and est.step % swap_every == 0 and est.step > 0:
            self._write_hot_swap()
            self._last_saved_step = est.step
        if self._publish_system_state is not None:
            self._publish_system_state(SystemStateMsg(
                mode=1,
                mission_graph_num_valid_node=st.mission_graph_num_valid_node,
                step=st.step,
                loss_total=st.loss_total,
                loss_trav=st.loss_trav,
                loss_reco=st.loss_reco,
                pause_learning=st.pause_learning,
            ).pack())
        return st

    # Services (reference wvn_learning_node.py:844-914)
    def save_checkpoint(self, mission_path: str, name: str = "last_checkpoint.ckpt"):
        return self.runtime.save_checkpoint(mission_path, name)

    def load_checkpoint(self, path: str):
        self.runtime.load_checkpoint(path)

    def pause(self, pause: bool):
        self.runtime.pause_learning(pause)

    def reset(self):
        self.runtime.reset()

    def shutdown(self, mission_path: str) -> str:
        """Final mission checkpoint and a last hot-swap write, so a
        restarting inference node rejoins at the latest weights (reference
        wvn_learning_node.py:148-174)."""
        self._write_hot_swap()
        return self.runtime.shutdown(mission_path)
