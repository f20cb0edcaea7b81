"""Runtime (node) parameter dataclasses (copied from
wild_visual_navigation_tpu/cfg/node_params.py with device="cuda").

Mirror of the reference's ROS-node param surface
(upstream wild_visual_navigation/cfg/ros_params.py:11-94) —
same fields and defaults (defaults come from
wild_visual_navigation_ros/config/wild_visual_navigation/default.yaml),
but populated from YAML overlays instead of a ROS param server. The
"two nodes" of the reference are one runtime here; both param groups
are kept so process-separated deployments stay configurable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from ..utils.operation_modes import WVNMode


def default_camera_topics() -> Dict[str, Any]:
    return {
        "front": {
            "image_topic": "/wide_angle_camera_front/image_color_rect",
            "info_topic": "/wide_angle_camera_front/camera_info",
            "use_for_training": True,
            "scheduler_weight": 1,
        }
    }


@dataclass
class LearningNodeParams:
    """Reference RosLearningNodeParams (ros_params.py:11-62); defaults
    from default.yaml."""

    camera_topics: Dict[str, Any] = field(default_factory=default_camera_topics)
    robot_state_topic: str = "/wild_visual_navigation_node/robot_state"
    desired_twist_topic: str = "/motion_reference/command_twist"

    fixed_frame: str = "odom"
    base_frame: str = "base"
    footprint_frame: str = "footprint"

    robot_length: float = 1.0
    robot_width: float = 0.6
    robot_height: float = 0.3

    traversability_radius: float = 3.0
    image_graph_dist_thr: float = 0.2
    supervision_graph_dist_thr: float = 0.1
    confidence_std_factor: float = 1.0
    min_samples_for_training: int = 5
    network_input_image_height: int = 224
    network_input_image_width: int = 224
    vis_node_index: int = 10

    untraversable_thr: float = 0.01

    mission_name: str = "test"
    mission_timestamp: bool = True

    image_callback_rate: float = 10.0
    supervision_callback_rate: float = 10.0
    learning_thread_rate: float = 10.0
    logging_thread_rate: float = 2.0
    load_save_checkpoint_rate: float = 1.0

    device: str = "cuda"
    mode: WVNMode = WVNMode.ONLINE
    colormap: str = "RdYlBu"

    print_image_callback_time: bool = False
    print_supervision_callback_time: bool = False
    log_time: bool = False
    log_confidence: bool = False
    verbose: bool = False

    extraction_store_folder: str = "nan"


@dataclass
class FeatureExtractorNodeParams:
    """Reference RosFeatureExtractorNodeParams (ros_params.py:65-94)."""

    camera_topics: Dict[str, Any] = field(default_factory=default_camera_topics)

    network_input_image_height: int = 224
    network_input_image_width: int = 224
    segmentation_type: str = "slic"
    feature_type: str = "dino"
    dino_patch_size: int = 8
    dino_backbone: str = "vit_small"
    # Backbone quantization of the JAX package (its models/quant.py):
    # None (bf16), "int8" or "int8_static". The torch port runs None only;
    # int8 is ROADMAP.md Queue 1, item 28.
    dino_quant: Any = None
    slic_num_components: int = 100
    grid_cell_size: int = 32  # grid-segmentation cell edge (this framework)

    confidence_std_factor: float = 1.0

    prediction_per_pixel: bool = True

    mode: WVNMode = WVNMode.ONLINE
    status_thread_rate: float = 0.5
    device: str = "cuda"
    log_confidence: bool = False
    verbose: bool = False

    image_callback_rate: float = 10.0
    load_save_checkpoint_rate: float = 1.0
