"""Parallelism layer of the port (counterpart of ``mptpu.parallel``): a
device mesh over ``torch.distributed`` ranks, data-parallel training and
dictionary-sharded matching pursuit."""

from .mesh import make_mesh
from .dict_shard import sharded_mp_correlate, sharded_sparse_code
from .dp import make_data_parallel_step, shard_batch

__all__ = ["make_mesh", "sharded_mp_correlate", "sharded_sparse_code",
           "make_data_parallel_step", "shard_batch"]
