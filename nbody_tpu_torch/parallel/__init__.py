from .sharding import ShardedWorld, make_mesh, shard_layout
from . import multihost

__all__ = ["ShardedWorld", "make_mesh", "shard_layout", "multihost"]
