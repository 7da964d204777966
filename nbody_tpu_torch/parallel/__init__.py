from .sharding import ShardedWorld, make_mesh, shard_layout

__all__ = ["ShardedWorld", "make_mesh", "shard_layout"]
