"""Training (port of ``repro.train``): AdamW, the train step with
microbatch accumulation and its sharded counterpart over a mesh, the loop,
and sealable checkpoints that restore in either package and onto another
mesh's shards."""

from repro_torch.train.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.train_loop import (TrainState, make_sharded_train_step,
                                          make_train_step)

__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint",
           "TrainState", "make_sharded_train_step", "make_train_step"]
