"""Data parallelism over ``torch.distributed`` (``dist.py``) and BatchNorm
over the global batch (``sync_bn.py``)."""
from .dist import (all_reduce_dict, all_reduce_sum, barrier,  # noqa: F401
                   check_same_on_ranks, initialize_distributed,
                   is_distributed, rank, rank_device, shard_batch, shard_rows,
                   spawn, world_size)
from .sync_bn import sync_batch_norm  # noqa: F401
