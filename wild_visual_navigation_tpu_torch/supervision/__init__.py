"""Self-supervision from proprioception: the supervision generator and the
twist-log dataset."""

from .supervision_generator import SupervisionGenerator, velocity_selection_matrix
from .twist_dataset import TwistDataModule, TwistDataset
