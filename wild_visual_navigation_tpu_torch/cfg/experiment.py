"""Experiment (learning) hyperparameters as plain dataclasses.

A copy of wild_visual_navigation_tpu/cfg/experiment.py that builds the
port's loss and confidence configs. Same defaults as upstream WVN's
structured config (cfg/experiment_params.py:14-180), minus the
Lightning / logger machinery.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.confidence_generator import ConfidenceConfig
from ..utils.loss import AnomalyLossConfig, TraversabilityLossConfig


@dataclass
class GeneralParams:
    name: str = "debug/debug"
    timestamp: bool = True
    log_confidence: bool = True
    model_path: Optional[str] = None


@dataclass
class LossParams:
    anomaly_balanced: bool = True
    w_trav: float = 0.03
    w_reco: float = 0.5
    w_temp: float = 0.0
    method: str = "latest_measurement"
    confidence_std_factor: float = 0.5
    trav_cross_entropy: bool = False


@dataclass
class LossAnomalyParams:
    method: str = "latest_measurement"
    confidence_std_factor: float = 0.5


@dataclass
class OptimizerParams:
    name: str = "ADAM"
    lr: float = 0.001


@dataclass
class AblationDataModuleParams:
    batch_size: int = 8
    num_workers: int = 0


@dataclass
class SimpleMlpCfgParams:
    input_size: int = 90  # 90 for stego, 384 for dino
    hidden_sizes: List[int] = field(default_factory=lambda: [256, 32, 1])
    reconstruction: bool = True

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclass
class DoubleMlpCfgParams:
    input_size: int = 384
    hidden_sizes: List[int] = field(default_factory=lambda: [64, 32, 1])

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclass
class SimpleGcnCfgParams:
    input_size: int = 384
    reconstruction: bool = True
    hidden_sizes: List[int] = field(default_factory=lambda: [256, 128, 1])

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclass
class LinearRnvpCfgParams:
    input_size: int = 384
    coupling_topology: List[int] = field(default_factory=lambda: [200])
    mask_type: str = "odds"
    use_permutation: bool = True
    single_function: bool = False
    flow_n: int = 2

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclass
class ModelParams:
    name: str = "SimpleMLP"  # LinearRnvp, SimpleMLP, SimpleGCN, DoubleMLP
    load_ckpt: Optional[str] = None
    simple_mlp_cfg: SimpleMlpCfgParams = field(default_factory=SimpleMlpCfgParams)
    double_mlp_cfg: DoubleMlpCfgParams = field(default_factory=DoubleMlpCfgParams)
    simple_gcn_cfg: SimpleGcnCfgParams = field(default_factory=SimpleGcnCfgParams)
    linear_rnvp_cfg: LinearRnvpCfgParams = field(default_factory=LinearRnvpCfgParams)

    def to_dict(self):
        return {
            "name": self.name,
            "simple_mlp_cfg": self.simple_mlp_cfg.to_dict(),
            "double_mlp_cfg": self.double_mlp_cfg.to_dict(),
            "simple_gcn_cfg": self.simple_gcn_cfg.to_dict(),
            "linear_rnvp_cfg": self.linear_rnvp_cfg.to_dict(),
        }


@dataclass
class ExperimentParams:
    general: GeneralParams = field(default_factory=GeneralParams)
    loss: LossParams = field(default_factory=LossParams)
    loss_anomaly: LossAnomalyParams = field(default_factory=LossAnomalyParams)
    optimizer: OptimizerParams = field(default_factory=OptimizerParams)
    ablation_data_module: AblationDataModuleParams = field(default_factory=AblationDataModuleParams)
    model: ModelParams = field(default_factory=ModelParams)

    def loss_cfg(self) -> TraversabilityLossConfig:
        return TraversabilityLossConfig(
            w_trav=self.loss.w_trav,
            w_reco=self.loss.w_reco,
            w_temp=self.loss.w_temp,
            anomaly_balanced=self.loss.anomaly_balanced,
            trav_cross_entropy=self.loss.trav_cross_entropy,
            confidence=ConfidenceConfig(
                std_factor=self.loss.confidence_std_factor, method=self.loss.method
            ),
        )

    def anomaly_loss_cfg(self) -> AnomalyLossConfig:
        return AnomalyLossConfig(
            confidence=ConfidenceConfig(
                std_factor=self.loss_anomaly.confidence_std_factor, method=self.loss_anomaly.method
            )
        )
