"""Data-parallel training across cards (counterpart of
``torchmdnet_tpu/parallel/``)."""

from torchmdnet_tpu_torch.parallel.dp import (
    launch, make_data_parallel_train_step, shard_batch)

__all__ = ["launch", "make_data_parallel_train_step", "shard_batch"]
