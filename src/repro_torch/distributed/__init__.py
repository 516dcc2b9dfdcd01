"""Shard execution: the mesh and its collectives (the engine's), and the
host-loop runtime under sharded serving."""
from repro_torch.distributed.runtime import ShardMesh, ShardRuntime

__all__ = ["ShardMesh", "ShardRuntime"]
