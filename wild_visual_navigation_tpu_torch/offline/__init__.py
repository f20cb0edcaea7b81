"""Offline training over exported mission graphs: the dataset, metrics,
loggers, the trainer and the loader of the reference's recorded graph
(port of wild_visual_navigation_tpu/offline/)."""

from .dataset import GraphTravDataset
from .loggers import get_logger
from .metrics import accuracy, auroc, optimal_threshold, roc_curve
from .trainer import OfflineTrainer, OfflineTrainerConfig
