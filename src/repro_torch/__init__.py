"""FrogWild! on PyTorch and CUDA: the port of ``repro`` (JAX + Pallas).

The same module layout and names as ``repro``; inside, plain PyTorch:
functions on tensors, an explicit ``device`` and explicit PRNG keys
(``repro_torch.prng``, bit for bit ``jax.random``'s threefry streams). The
walker superstep (resident or streamed), the stitch rounds (over a dense
slab or per shard) and the histograms run through hand-written CUDA
kernels (``repro_torch/kernels``) on the card and through their plain
PyTorch versions on the CPU. Entry points run on the card unless the
caller passes ``device="cpu"``. The batch estimate runs the plain walk
(p_s = 1) and the partial-synchronization walks (``erasure=
"independent"`` or ``"channel"`` with p_s < 1); the GraphLab-PR baseline,
``core.power_iteration(spmv="ell")``, runs through the hand-written ELL
SpMV kernel. The LM stack (``repro_torch.models``, ``configs``,
``serving``, ``launch.serve``: the dense, MoE, RWKV-6 and Mamba-2 hybrid
families) runs its attention through the hand-written
``flash_attention`` kernel and its time recurrences through the
hand-written ``wkv6_scan`` and ``ssd_scan``, and serves through KV
caches and constant-size recurrent states. Its attention families train
(``repro_torch.training``, ``data``, ``launch.train``), the attention's
backward a hand-written kernel too.

Dynamic graphs (``repro_torch.dynamic``): edge mutation batches compact
into a new graph epoch, and the walk index is refreshed in place of a
rebuild through the same hop kernel, which records each segment's
visited-block mask as it walks.

The serving gateway (``repro_torch.gateway``, :class:`Gateway`): replicas
of the service over one walk index in device memory, behind an (ε,
δ)-aware result cache, in-flight joins, supervised failover and a stdlib
HTTP front end.

The port never imports ``jax`` or ``repro``.
"""
from repro_torch.config import (FrogWildConfig, KernelConfig, RuntimeConfig,
                                ServingConfig, ShardConfig, WalkIndexConfig)
from repro_torch.distributed.runtime import ShardRuntime
from repro_torch.gateway import Gateway
from repro_torch.query.index import ShardedWalkIndex, WalkIndex
from repro_torch.service import (FrogWildService, QueryHandle,
                                 batch_pagerank, build_index)

# the reference's public surface; the other names above stay importable
# from here
__all__ = [
    "FrogWildService",
    "Gateway",
    "KernelConfig",
    "QueryHandle",
    "RuntimeConfig",
    "ServingConfig",
    "ShardConfig",
]
