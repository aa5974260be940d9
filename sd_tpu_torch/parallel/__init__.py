"""The parallel layer: the rank mesh and its layouts (`mesh`) and the
process-group bring-up (`multihost`)."""

from sd_tpu_torch.parallel import multihost
from sd_tpu_torch.parallel.mesh import (
    TP_RULES_UNET,
    fsdp_state_sharding,
    gan_state_sharding,
    infer_param_sharding,
    make_mesh,
    make_parallel_train_step,
    replicated,
    shard_batch,
    zero_state_sharding,
)

__all__ = ["TP_RULES_UNET", "fsdp_state_sharding", "gan_state_sharding",
           "infer_param_sharding", "make_mesh", "make_parallel_train_step", "multihost",
           "replicated", "shard_batch", "zero_state_sharding"]
