"""Shard execution: the host-loop runtime under sharded serving."""
from repro_torch.distributed.runtime import ShardRuntime

__all__ = ["ShardRuntime"]
