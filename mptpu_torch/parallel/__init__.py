"""Parallelism layer of the port (counterpart of ``mptpu.parallel``; only
the ported names): a device mesh over ``torch.distributed`` ranks and
dictionary-sharded matching pursuit."""

from .mesh import make_mesh
from .dict_shard import sharded_mp_correlate, sharded_sparse_code

__all__ = ["make_mesh", "sharded_mp_correlate", "sharded_sparse_code"]
