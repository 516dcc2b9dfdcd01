"""Service facade: one front door for batch PageRank, the walk index, and
top-k / PPR serving (port of ``repro/service.py``, single device).

* :class:`FrogWildService` — ``open(graph_or_path, config, device=)`` owns
  the graph on its device and the walk-index lifecycle (build, or load,
  repair or build and persist through ``checkpoint/`` when
  ``serving.checkpoint_dir`` is set). ``pagerank(ε, δ)``
  inverts Theorem 1 into ``(t, N)`` and runs the walker estimator;
  ``topk`` / ``ppr`` return :class:`QueryHandle` futures served by the
  continuous-batching scheduler.
* :class:`QueryHandle` — ``poll()`` / ``partial()`` / ``result()`` /
  ``cancel()``; with ``early_stop`` (the default) a query finishes once the
  anytime Theorem 1 bound reaches its ε. ``join(ε, δ)`` attaches a
  duplicate request whose target it dominates (a
  :class:`JoinedQueryHandle`, no walks of its own), and
  :meth:`FrogWildService.resubmit` replays a request under a fresh rid:
  the gateway's in-flight join and failover (``repro_torch.gateway``).
* :func:`batch_pagerank` / :func:`build_index` — the module-level
  dispatchers under the facade.

With ``runtime.num_shards = S > 1`` the service serves the walk index as
``S`` range-partitioned blocks on its one device (a host-loop
:class:`ShardRuntime`), through the fused or the per-shard loop wave
(``serving.sharded_dispatch``); the batch estimate stays the single-device
walk, as in the reference without a mesh. A service opened with ``mesh=``
(a :class:`~repro_torch.distributed.runtime.ShardMesh`) runs its batch
estimate through the distributed engine (``engine/gas.py``, ``ROADMAP.md``
Queue 1 item 8b) and returns its :class:`~repro_torch.engine.gas.
EngineResult`; serving over a mesh is item 8c. ``kernel.step_impl="stream"``
runs the batch walk and the index build through the streamed superstep,
whose slab layout the service builds once and keeps.

The batch estimate also runs the partial-synchronization walks
(``erasure="independent"`` or ``"channel"`` with ``p_s < 1``; the channel
model's destination shards are ``runtime.num_shards``) with the blocking
draw ``kernel.draw`` picks.

``RuntimeConfig.faults`` (a :class:`~repro_torch.distributed.faults.
FaultPlan`) gives the service one :class:`FaultInjector`: the scheduler's
wave supervisor consults it each (wave, attempt), and the index loader lets
it mangle the checkpoint payloads before their first read. Evicted shards
and the supervisor's log are :attr:`FrogWildService.lost_shards` and
:attr:`FrogWildService.fault_log`.

Dynamic graphs: :meth:`FrogWildService.apply_mutations` compacts a
:class:`~repro_torch.dynamic.MutationBatch` into the graph's next epoch,
refreshes exactly the invalidated walk segments (``repro_torch.dynamic``)
and commits the two-epoch swap (:meth:`FrogWildService.commit_epoch`):
queries admitted before it finish on their own epoch's scheduler, which
:meth:`~FrogWildService.step` and :meth:`~FrogWildService.drain` keep
driving until they settle, and new admissions land on the new epoch.

``device=None`` means the CUDA card everywhere (a mesh's device where a
mesh is given); without one these raise, and ``device="cpu"`` runs the
plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Union

import torch

from repro_torch import prng
from repro_torch.checkpoint import CheckpointCorruptError
from repro_torch.config import (EngineConfig, FrogWildConfig, KernelConfig,
                                RuntimeConfig, ServingConfig, ShardConfig,
                                WalkIndexConfig)
from repro_torch.core.frogwild import (FrogWildResult, _frogwild_walks,
                                      compiled_estimate)
from repro_torch.device import DeviceLike, on_device, resolve_device
from repro_torch.distributed.faults import FaultInjector, WaveFailedError
from repro_torch.distributed.runtime import ShardMesh, ShardRuntime
from repro_torch.engine import gas as _gas
from repro_torch.graph.csr import CSRGraph, load_graph
from repro_torch.kernels.frog_step_stream import BlockedCSR, blocked_csr_of
from repro_torch.query.engine import plan_query
from repro_torch.query.index import (ShardedWalkIndex, WalkIndex,
                                     _build_walk_index,
                                     load_or_repair_walk_index,
                                     save_walk_index, shard_walk_index)
from repro_torch.query.scheduler import (QueryPartial, QueryRequest,
                                         QueryResult, QueryScheduler,
                                         SchedulerStats)

__all__ = [
    "FrogWildService",
    "JoinedQueryHandle",
    "QueryHandle",
    "QueryPartial",
    "RuntimeConfig",
    "KernelConfig",
    "ShardConfig",
    "ServingConfig",
    "batch_pagerank",
    "build_index",
]


def _key_on(key: Optional[torch.Tensor], seed: int,
            device: torch.device) -> torch.Tensor:
    if key is None:
        return prng.PRNGKey(seed, device)
    return prng.wrap_key_data(key, device)


def _mesh_device(device: DeviceLike, mesh: Optional[ShardMesh]
                 ) -> torch.device:
    """``device``, or the mesh's where none is given; a mesh elsewhere
    raises."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a ShardMesh, got "
                        f"{type(mesh).__name__}")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} differs from the mesh's "
                         f"{mesh.device}")
    return mesh.device


def batch_pagerank(graph: Union[CSRGraph, "_gas.DistributedGraph"],
                   config: Union[RuntimeConfig, FrogWildConfig,
                                 EngineConfig], *,
                   key: Optional[torch.Tensor] = None,
                   seed: Optional[int] = None,
                   device: DeviceLike = None,
                   mesh: Optional[ShardMesh] = None):
    """One batch FrogWild run: the single dispatch point under
    :meth:`FrogWildService.pagerank` and the engine's deprecated
    ``distributed_frogwild``.

    A mesh (or a prebuilt :class:`~repro_torch.engine.gas.
    DistributedGraph`) runs the distributed engine seeded by ``seed`` and
    returns its :class:`~repro_torch.engine.gas.EngineResult`; otherwise
    the walker estimator runs on ``device`` (default: the card) with
    ``key`` (or ``PRNGKey(seed)``, seed 0 by default)."""
    if isinstance(graph, _gas.DistributedGraph) or mesh is not None:
        if mesh is None:
            raise ValueError("a DistributedGraph run needs mesh=")
        _mesh_device(device, mesh)
        if isinstance(config, RuntimeConfig):
            rc, cfg = config, config.engine()
        elif isinstance(config, EngineConfig):
            rc, cfg = None, config
        else:
            raise TypeError(f"an engine run takes a RuntimeConfig or an "
                            f"EngineConfig, got {type(config).__name__}")
        if not isinstance(graph, _gas.DistributedGraph):
            vb = rc.runtime.vertex_block if rc is not None else None
            graph = _gas.build_distributed_graph(graph, mesh.num_shards,
                                                 vertex_block=vb)
        return _gas._distributed_frogwild(graph, cfg, mesh,
                                          seed=0 if seed is None else seed)
    dev = resolve_device(device)
    cfg = config.frogwild() if isinstance(config, RuntimeConfig) else config
    return _frogwild_walks(graph.to(dev), cfg,
                           _key_on(key, 0 if seed is None else seed, dev))


def build_index(graph: CSRGraph,
                config: Union[RuntimeConfig, WalkIndexConfig], *,
                key: Optional[torch.Tensor] = None,
                device: DeviceLike = None) -> WalkIndex:
    """One walk-index build on ``device`` (default: the card), the host
    shard loop over ``build_shards`` range shards."""
    dev = resolve_device(device)
    cfg = (config.walk_index() if isinstance(config, RuntimeConfig)
           else config)
    if key is not None:
        key = prng.wrap_key_data(key, dev)
    return _build_walk_index(graph.to(dev), cfg, key)


def _on_device(index, device: torch.device):
    """``index`` (or ``None``) with its slab and masks on ``device``:
    ``index`` itself when they are there already, so services handed one
    index (a replica pool's) share its object and its tensors."""
    if index is None:
        return None
    vb = index.visited_blocks
    slab = index.endpoints if isinstance(index, WalkIndex) else index.blocks
    if on_device(slab, device) and (vb is None or on_device(vb, device)):
        return index
    vb = None if vb is None else vb.to(device)
    if isinstance(index, WalkIndex):
        return dataclasses.replace(index, endpoints=index.endpoints.to(device),
                                   visited_blocks=vb)
    return dataclasses.replace(index, blocks=index.blocks.to(device),
                               visited_blocks=vb)


class QueryHandle:
    """Future for one submitted query, with anytime (ε, δ) refinement.

    Handles are cooperative: any handle's ``poll()`` / ``result()``
    advances the shared scheduler, so all in-flight queries progress
    together (continuous batching).

    A handle pins the scheduler, and so the graph epoch and slab, it was
    admitted on: an epoch commit swaps the service's current scheduler,
    and this handle finishes on its own, byte-identical to a run in which
    no mutation happened.
    """

    def __init__(self, service: "FrogWildService", request: QueryRequest,
                 decision, scheduler: QueryScheduler):
        self._service = service
        self._sched = scheduler
        self.request = request
        self.decision = decision

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def admitted(self) -> bool:
        return bool(self.decision.admitted)

    def status(self) -> str:
        """``rejected`` | ``queued`` | ``active`` | ``finished`` |
        ``cancelled``."""
        if not self.admitted:
            return "rejected"
        if self._service.closed:
            return "cancelled"
        return self._sched.query_state(self.rid)

    def done(self) -> bool:
        return self.status() in ("finished", "cancelled", "rejected")

    def poll(self) -> bool:
        """Advances the service by one wave unless already done."""
        if not self.done():
            self._service.step()
        return self.done()

    def partial(self) -> QueryPartial:
        """Current anytime snapshot (no waves are driven)."""
        st = self.status()
        if st in ("rejected", "cancelled"):
            raise RuntimeError(
                f"query {self.rid} is {st}"
                + (f": {self.decision.reason}" if st == "rejected" else ""))
        return self._sched.partial(self.rid)

    def result(self, max_waves: Optional[int] = None) -> QueryResult:
        """Drives waves until this query finishes and returns its result."""
        if not self.admitted:
            raise RuntimeError(
                f"query {self.rid} rejected at admission: "
                f"{self.decision.reason}")
        waves = 0
        while True:
            st = self.status()
            if st == "finished":
                return self._sched.result_for(self.rid)
            if st == "cancelled":
                raise RuntimeError(f"query {self.rid} was cancelled")
            if max_waves is not None and waves >= max_waves:
                raise TimeoutError(
                    f"query {self.rid} still {st} after {waves} waves")
            if not self._service.step():
                raise RuntimeError(
                    f"scheduler idle but query {self.rid} is {st}")
            waves += 1

    def cancel(self) -> bool:
        """Drops the query; False when it already finished (or never ran)."""
        if not self.admitted or self._service.closed:
            return False
        return self._sched.cancel(self.rid)

    def join(self, epsilon: Optional[float] = None,
             delta: Optional[float] = None) -> "JoinedQueryHandle":
        """Attaches a duplicate request to this live handle (the gateway's
        in-flight join).

        Valid only when this handle's target dominates the joiner's
        (``self.ε ≤ ε`` and ``self.δ ≤ δ``): Theorem 1 then certifies the
        joiner's weaker bound from the walks already running, no later
        than this handle's own. The joined handle runs no walks of its
        own; it settles the wave its (ε, δ) is certified, at the latest
        the wave this handle finishes.
        """
        eps = self.request.epsilon if epsilon is None else epsilon
        dlt = self.request.delta if delta is None else delta
        if self.request.epsilon > eps or self.request.delta > dlt:
            raise ValueError(
                f"cannot join query {self.rid}: its target "
                f"(ε={self.request.epsilon}, δ={self.request.delta}) does "
                f"not dominate the joiner's (ε={eps}, δ={dlt}) — submit a "
                f"fresh query instead")
        if not self.admitted:
            raise RuntimeError(
                f"cannot join rejected query {self.rid}: "
                f"{self.decision.reason}")
        return JoinedQueryHandle(self, eps, dlt)


class JoinedQueryHandle:
    """A duplicate request riding a live :class:`QueryHandle`.

    Made by :meth:`QueryHandle.join`; the parent's (ε, δ) target dominates
    this one's. ``poll()`` / ``result()`` drive the parent's service,
    ``partial()`` is the parent's snapshot, and the join settles the wave
    its own (ε, δ) is certified by the walks tallied so far. With the
    parent's target, the settled result is the parent's
    :class:`~repro_torch.query.scheduler.QueryResult` object.
    """

    def __init__(self, parent: QueryHandle, epsilon: float, delta: float):
        self.parent = parent
        self.epsilon = epsilon
        self.delta = delta
        self._result: Optional[QueryResult] = None
        self._t_join = time.perf_counter()

    @property
    def rid(self) -> int:
        return self.parent.rid

    @property
    def admitted(self) -> bool:
        return self.parent.admitted

    def done(self) -> bool:
        """True when settled, or terminal: a parent cancelled or rejected
        before certifying this join never will, so the join reports done
        (its ``result()`` then raises)."""
        if self._result is not None or self._settle():
            return True
        return self.parent.status() in ("cancelled", "rejected")

    def poll(self) -> bool:
        """Advances the parent's service by one wave unless already done."""
        if not self.done():
            self.parent._service.step()
        return self.done()

    def partial(self) -> QueryPartial:
        """The parent's anytime snapshot (shared tallies)."""
        return self.parent.partial()

    def _settle(self) -> bool:
        """Settles the joined result once certifiable; False until then."""
        parent = self.parent
        st = parent.status()
        if st == "finished":
            # the parent's certificate dominates this join's target
            self._result = parent._sched.result_for(parent.rid)
            return True
        if st != "active":
            return False
        if (self.epsilon, self.delta) == (parent.request.epsilon,
                                          parent.request.delta):
            return False             # the parent's target: settle with it
        sched = parent._sched
        p = sched.partial(self.rid)
        if not p.walks_done:
            return False
        bound = sched.anytime_bound(parent.decision.plan.num_steps,
                                    parent.request.k, self.delta,
                                    p.walks_done)
        if bound > self.epsilon:
            return False
        # the weaker bound holds mid-flight: this wave's snapshot is the
        # joined result while the parent keeps refining
        self._result = QueryResult(
            rid=p.rid, kind=p.kind, vertices=p.vertices, scores=p.scores,
            num_walks=p.walks_done,
            num_steps=parent.decision.plan.num_steps, waves=p.waves,
            latency_s=time.perf_counter() - self._t_join,
            epsilon_bound=bound, early_stopped=True, degraded=p.degraded,
            shards_lost=p.shards_lost, walks_lost=p.walks_lost,
            epoch=sched.epoch)
        return True

    def result(self, max_waves: Optional[int] = None) -> QueryResult:
        """Drives waves until this join's (ε, δ) is certified; a parent
        cancelled or rejected first raises :class:`~repro_torch.
        distributed.faults.WaveFailedError`."""
        waves = 0
        while True:
            if self.done():
                if self._result is None:
                    st = self.parent.status()
                    raise WaveFailedError(
                        f"joined query {self.rid}: parent handle is {st} "
                        f"before this join's (ε={self.epsilon}, "
                        f"δ={self.delta}) was certified — resubmit")
                return self._result
            st = self.parent.status()
            if max_waves is not None and waves >= max_waves:
                raise TimeoutError(
                    f"joined query {self.rid} still {st} after "
                    f"{waves} waves")
            if not self.parent._service.step():
                raise RuntimeError(
                    f"scheduler idle but joined query {self.rid} is {st}")
            waves += 1


class FrogWildService:
    """Batch PageRank, walk-index lifecycle and top-k / PPR serving over
    one graph on one device. Build one with :meth:`open`; the index and the
    scheduler are built lazily."""

    def __init__(self, graph: CSRGraph, config: RuntimeConfig,
                 device: torch.device,
                 index: Union[WalkIndex, ShardedWalkIndex, None] = None,
                 mesh: Optional[ShardMesh] = None):
        self.device = device
        self.graph = graph.to(device)
        self.config = config
        S = config.runtime.num_shards
        self.runtime = ShardRuntime.acquire(S) if S > 1 else None
        self._mesh = mesh
        self._index = _on_device(index, device)
        self._blocked: Optional[BlockedCSR] = None
        # the engine's per-shard blocks, cached per (S, vertex_block)
        self._dg: Optional["_gas.DistributedGraph"] = None
        self._dg_key = None
        self._scheduler: Optional[QueryScheduler] = None
        # retired epochs' schedulers, kept until their last pinned query
        # settles (commit_epoch, step)
        self._retiring: List[QueryScheduler] = []
        self._next_rid = 0
        self._closed = False
        self._injector = (FaultInjector(config.faults)
                          if config.faults is not None else None)

    # --- lifecycle -------------------------------------------------------

    @classmethod
    def open(cls, graph_or_path: Union[CSRGraph, str, os.PathLike],
             config: Optional[RuntimeConfig] = None, *,
             device: DeviceLike = None,
             index: Union[WalkIndex, ShardedWalkIndex, None] = None,
             mesh: Optional[ShardMesh] = None) -> "FrogWildService":
        """Opens a service over a graph (or a ``save_graph`` ``.npz`` path)
        on ``device`` (default: the mesh's device, else the card; raises
        without one). ``mesh`` routes batch runs through the distributed
        engine; ``index`` short-circuits the index build with a prebuilt
        slab."""
        dev = _mesh_device(device, mesh)
        if config is None:
            config = RuntimeConfig()
        elif not isinstance(config, RuntimeConfig):
            raise TypeError(f"config must be a RuntimeConfig, got "
                            f"{type(config).__name__}")
        if isinstance(graph_or_path, (str, os.PathLike)):
            graph = load_graph(os.fspath(graph_or_path))
        elif isinstance(graph_or_path, CSRGraph):
            graph = graph_or_path
        else:
            raise TypeError(
                f"graph_or_path must be a CSRGraph or a path, got "
                f"{type(graph_or_path).__name__}")
        return cls(graph, config, dev, index=index, mesh=mesh)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Cancels queued and in-flight queries and drops the scheduler and
        the service's references to the index; idempotent. The index's
        tensors stay untouched (a replica pool's other services share
        them). New work on a closed service raises."""
        if self._closed:
            return
        for sched in [self._scheduler] + self._retiring:
            if sched is not None:
                for rid in ([e.req.rid for e in sched.queue]
                            + [a.req.rid for a in sched.active.values()]):
                    sched.cancel(rid)
        self._retiring = []
        self._scheduler = None
        self._index = None
        self._blocked = None
        self._dg = None
        self._dg_key = None
        self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "FrogWildService is closed — open a new service to submit "
                "more work")

    def __enter__(self) -> "FrogWildService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- walk index ------------------------------------------------------

    def ensure_index(self) -> Union[WalkIndex, ShardedWalkIndex]:
        """Builds, loads or reuses the walk index on the service's device
        (idempotent).

        With ``serving.checkpoint_dir`` set, an index there is loaded (a
        corrupt, torn or missing shard of the per-shard layout quarantined
        and rebuilt in place) and checked against the configured (R, L)
        and the graph's epoch; otherwise, or when the dense checkpoint is
        corrupt, the index is built and persisted there.
        ``runtime.num_shards = S > 1`` declares the serving layout: a dense
        slab (built, loaded or passed in) is range-partitioned into ``S``
        blocks and dropped, and a sharded one laid out for another shard
        count is re-split.
        """
        self._check_open()
        if self._index is None:
            self._index = self._load_or_build_index()
        S = self.config.runtime.num_shards
        if S > 1:
            if isinstance(self._index, WalkIndex):
                self._index = shard_walk_index(self._index, S)
            elif self._index.num_shards != S:
                self._index = shard_walk_index(self._index.reassemble(), S)
        return self._index

    def _load_or_build_index(self) -> Union[WalkIndex, ShardedWalkIndex]:
        icfg = self.config.walk_index()
        blocked = self.blocked_csr() if icfg.step_impl == "stream" else None
        directory = self.config.serving.checkpoint_dir
        if directory is not None:
            if self._injector is not None:
                # mangle the on-disk payloads before the first read, so
                # the repair below is what serves
                self._injector.mangle_checkpoints(directory)
            try:
                idx = load_or_repair_walk_index(
                    directory, self.graph, icfg,
                    reassemble=self.config.runtime.num_shards <= 1,
                    blocked=blocked)
            except (FileNotFoundError, CheckpointCorruptError):
                # nothing there, or a corrupt dense checkpoint (no shard
                # to repair): build, and the atomic save replaces it
                idx = None
            if idx is not None:
                if (idx.segments_per_vertex != icfg.segments_per_vertex
                        or idx.segment_len != icfg.segment_len):
                    raise ValueError(
                        f"walk index under {directory!r} has (R, L) = "
                        f"({idx.segments_per_vertex}, {idx.segment_len}) "
                        f"but the config wants "
                        f"({icfg.segments_per_vertex}, {icfg.segment_len});"
                        f" rebuild or point checkpoint_dir elsewhere")
                if idx.graph_epoch != self.graph.epoch:
                    raise ValueError(
                        f"walk index under {directory!r} was built at "
                        f"graph epoch {idx.graph_epoch} but the service "
                        f"graph is at epoch {self.graph.epoch} — a stale "
                        f"slab would serve wrong answers silently; refresh "
                        f"it (repro_torch.dynamic.refresh_walk_index / "
                        f"load_epoch_index) or rebuild")
                return idx
        idx = _build_walk_index(self.graph, icfg, blocked=blocked)
        if directory is not None:
            save_walk_index(directory, idx)
        return idx

    # --- batch -----------------------------------------------------------

    def pagerank(self, epsilon: Optional[float] = None, delta: float = 0.1,
                 k: int = 10, *, key: Optional[torch.Tensor] = None,
                 seed: Optional[int] = None,
                 config: Optional[RuntimeConfig] = None):
        """One batch FrogWild estimate of the full PageRank vector.

        With ``epsilon`` given, Theorem 1 is inverted into ``(t, N)`` for a
        ``μ_k`` guarantee at confidence ``1 − delta`` (``t`` capped by
        ``serving.max_steps``); otherwise the config's ``num_frogs`` /
        ``num_steps`` run as they are. A service opened with a mesh runs
        the distributed engine (seeded by ``seed``, else
        ``runtime.seed``) and returns its :class:`~repro_torch.engine.gas.
        EngineResult`; otherwise the walker estimator's
        :class:`FrogWildResult`.
        """
        self._check_open()
        rc = config if config is not None else self.config
        if epsilon is not None:
            plan = plan_query(k, epsilon, delta, p_T=rc.p_T,
                              max_steps=rc.serving.max_steps)
            rc = dataclasses.replace(rc, num_frogs=plan.num_walks,
                                     num_steps=plan.num_steps)
        if self._mesh is not None:
            return batch_pagerank(
                self._dgraph(rc), rc.engine(), mesh=self._mesh,
                seed=rc.runtime.seed if seed is None else seed)
        key = _key_on(key, rc.runtime.seed if seed is None else seed,
                      self.device)
        cfg = rc.frogwild()
        blocked = self.blocked_csr() if cfg.step_impl == "stream" else None
        return compiled_estimate(
            _frogwild_walks(self.graph, cfg, key, blocked))

    def _dgraph(self, rc: RuntimeConfig) -> "_gas.DistributedGraph":
        """The engine's per-shard blocks of the graph on the service's
        device, built at first use and kept per (S, vertex_block)."""
        shape = (self._mesh.num_shards, rc.runtime.vertex_block)
        if self._dg is None or self._dg_key != shape:
            self._dg = _gas.build_distributed_graph(
                self.graph, shape[0], vertex_block=shape[1])
            self._dg_key = shape
        return self._dg

    def blocked_csr(self) -> BlockedCSR:
        """The graph's slab layout for ``step_impl="stream"``, built on
        the service's device at first use and kept."""
        self._check_open()
        if self._blocked is None:
            self._blocked = blocked_csr_of(self.graph)
        return self._blocked

    # --- serving ---------------------------------------------------------

    @property
    def scheduler(self) -> QueryScheduler:
        """The (lazily built) continuous-batching scheduler."""
        self._check_open()
        if self._scheduler is None:
            index = self.ensure_index()
            scfg = self.config.serving
            self._scheduler = QueryScheduler(
                self.graph, index, max_walks=scfg.max_walks,
                max_queries=scfg.max_queries, max_steps=scfg.max_steps,
                p_T=self.config.p_T, impl=self.config.kernel.stitch_impl,
                tally_impl=self.config.kernel.tally_impl,
                seed=self.config.runtime.seed, runtime=self.runtime,
                wave_time_estimate_s=scfg.wave_time_estimate_s,
                fault_injector=self._injector,
                wave_timeout_s=scfg.wave_timeout_s,
                max_retries=scfg.max_retries,
                backoff_base_s=scfg.backoff_base_s,
                backoff_max_s=scfg.backoff_max_s,
                sharded_dispatch=scfg.sharded_dispatch,
                walk_buckets=scfg.walk_buckets,
                query_buckets=scfg.query_buckets)
        return self._scheduler

    @property
    def lost_shards(self) -> frozenset:
        """Shards evicted from serving so far (empty before any fault)."""
        if self._scheduler is None:
            return frozenset()
        return frozenset(self._scheduler.lost_shards)

    @property
    def fault_log(self) -> list:
        """The wave supervisor's fault log (chronological
        :class:`~repro_torch.distributed.faults.FaultEvent` entries)."""
        if self._scheduler is None:
            return []
        return list(self._scheduler.fault_log)

    def serving_stats(self) -> Optional[SchedulerStats]:
        """The scheduler's snapshot; ``None`` before the first query."""
        if self._closed or self._scheduler is None:
            return None
        return self._scheduler.stats()

    def topk(self, k: int = 10, epsilon: float = 0.3, delta: float = 0.1, *,
             num_walks: Optional[int] = None, slo_s: Optional[float] = None,
             allow_downgrade: bool = False,
             early_stop: bool = True) -> QueryHandle:
        """Submits a global top-k query; returns its :class:`QueryHandle`."""
        return self._submit_request(
            kind="topk", k=k, source=0, epsilon=epsilon, delta=delta,
            num_walks=num_walks, slo_s=slo_s,
            allow_downgrade=allow_downgrade, early_stop=early_stop)

    def ppr(self, source: int, k: int = 10, epsilon: float = 0.3,
            delta: float = 0.1, *, num_walks: Optional[int] = None,
            slo_s: Optional[float] = None, allow_downgrade: bool = False,
            early_stop: bool = True) -> QueryHandle:
        """Submits a personalized-PageRank query pinned at ``source``."""
        return self._submit_request(
            kind="ppr", k=k, source=source, epsilon=epsilon, delta=delta,
            num_walks=num_walks, slo_s=slo_s,
            allow_downgrade=allow_downgrade, early_stop=early_stop)

    def _submit_request(self, **kw) -> QueryHandle:
        req = QueryRequest(rid=self._next_rid, **kw)
        self._next_rid += 1
        sched = self.scheduler
        decision = sched._submit(req)
        return QueryHandle(self, req, decision, sched)

    def resubmit(self, req: QueryRequest) -> QueryHandle:
        """Submits a fresh copy of ``req`` (new rid, new latency clock):
        the gateway's failover and hedge hook. On a cold or restarted
        replica the scheduler's key stream starts at wave 0, so the
        replayed answer is byte-equal to a fault-free run on a cold
        replica."""
        return self._submit_request(
            kind=req.kind, k=req.k, source=req.source, epsilon=req.epsilon,
            delta=req.delta, num_walks=req.num_walks, slo_s=req.slo_s,
            allow_downgrade=req.allow_downgrade, early_stop=req.early_stop)

    def step(self) -> bool:
        """Runs one wave; False when nothing is in flight.

        Drives the current epoch's scheduler first, then each retiring
        epoch's that still carries pinned queries; a retiring scheduler
        whose last pinned query has settled is released here (its handles
        keep their own references for ``result_for``).
        """
        progressed = self.scheduler.step_wave()
        for sched in list(self._retiring):
            if sched.queue or sched.active:
                progressed = sched.step_wave() or progressed
            if not sched.queue and not sched.active:
                self._retiring.remove(sched)
        return progressed

    def drain(self) -> List[QueryResult]:
        """Drives waves until queue and slots are empty, the retiring
        epochs' included; returns the current epoch's results finished so
        far (in finish order)."""
        while self._retiring and self.step():
            pass
        return self.scheduler._drain()

    # --- dynamic graphs (epoch lifecycle) ---------------------------------

    @property
    def graph_epoch(self) -> int:
        """The mutation epoch new admissions land on."""
        return self.graph.epoch

    @property
    def retiring_epochs(self) -> List[int]:
        """Epochs still draining pinned queries (oldest first)."""
        return [s.epoch for s in self._retiring]

    def commit_epoch(self, graph: CSRGraph,
                     index: Union[WalkIndex, ShardedWalkIndex]) -> int:
        """Swaps serving to ``(graph, index)`` at their epoch.

        The current scheduler, if it still carries queued or active
        queries, moves to the retiring list and keeps draining through
        :meth:`step`; its handles finish byte-identically to a run in
        which no mutation happened (each scheduler owns its key stream,
        seeded the same). New admissions land on the new epoch at once.
        Every cache of the old graph goes: the index and the
        ``BlockedCSR``. Returns the committed epoch.
        """
        self._check_open()
        if graph.n != self.graph.n:
            raise ValueError(
                f"epoch commit cannot change the vertex count "
                f"({self.graph.n} → {graph.n})")
        if index.graph_epoch != graph.epoch:
            raise ValueError(
                f"slab epoch {index.graph_epoch} does not match graph "
                f"epoch {graph.epoch} — refusing a mismatched commit")
        icfg = self.config.walk_index()
        if (index.segments_per_vertex != icfg.segments_per_vertex
                or index.segment_len != icfg.segment_len):
            raise ValueError(
                f"slab geometry (R, L) = ({index.segments_per_vertex}, "
                f"{index.segment_len}) does not match the service config "
                f"({icfg.segments_per_vertex}, {icfg.segment_len})")
        old = self._scheduler
        if old is not None and (old.queue or old.active):
            self._retiring.append(old)
        self._scheduler = None
        self.graph = graph.to(self.device)
        self._index = _on_device(index, self.device)
        self._blocked = None
        self._dg = None
        self._dg_key = None
        return graph.epoch

    def apply_mutations(self, batch, *, chunk: int = 1024):
        """Applies one mutation batch end to end: compacts the CSR at
        ``epoch + 1``, refreshes exactly the invalidated walk segments on
        the service's device, persists the new slab under its epoch
        directory (when ``serving.checkpoint_dir`` is set) and commits the
        two-epoch swap. Returns the :class:`repro_torch.dynamic.
        RefreshReport`."""
        from repro_torch.dynamic import (apply_mutations as _apply,
                                         refresh_walk_index,
                                         save_epoch_index)

        self._check_open()
        index = self.ensure_index()
        new_graph, changed = _apply(self.graph, batch)
        step_impl = self.config.walk_index().step_impl
        blocked = (blocked_csr_of(new_graph) if step_impl == "stream"
                   else None)
        new_index, report = refresh_walk_index(
            index, new_graph, changed, step_impl=step_impl, chunk=chunk,
            blocked=blocked)
        directory = self.config.serving.checkpoint_dir
        if directory is not None:
            save_epoch_index(directory, new_index)
        self.commit_epoch(new_graph, new_index)
        self._blocked = blocked
        return report
