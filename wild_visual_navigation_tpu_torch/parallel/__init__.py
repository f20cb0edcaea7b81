"""The parallel layer on torch.distributed: the ("dp", "tp") mesh, its
sharding rules and multi-rank steps (mesh.py), and the multi-process
trainer (distributed.py). Port of wild_visual_navigation_tpu/parallel/."""

from .distributed import DistributedTrainer, create_global_mesh, initialize_process
from .mesh import (
    create_mesh,
    make_multichip_inference,
    make_multichip_train_step,
    mlp_param_spec,
    shard_module,
    vit_param_spec,
)
