"""The serving gateway on one device (port of ``repro/gateway``): a
replica pool, an (ε, δ)-aware result cache, and a metrics/health layer
above the :class:`~repro_torch.service.FrogWildService` facade.

FrogWild's Theorem 1 certificates make result reuse principled rather
than heuristic. The tier's one invariant — the **dominance contract** —
is:

    a cached (or in-flight) answer certified at (ε′, δ′) may serve a
    request for (ε, δ) **iff ε′ ≤ ε and δ′ ≤ δ** — the stored guarantee
    is at least as strong in both coordinates, so the caller receives
    exactly the accuracy they asked for (or better) with zero new walks.

Three layers enforce it:

* :class:`~repro_torch.gateway.pool.ReplicaPool` — N service replicas
  sharing ONE graph and walk index in device memory (one object, one set
  of tensors; no N-fold copy), routed by EDF-charged queue depth from each
  scheduler's admission accounting.
* :class:`~repro_torch.gateway.cache.ResultCache` — a Pareto frontier of
  certificates per (kind, k, source, graph-epoch) key; degraded answers
  are never cached; epoch bumps orphan stale keys.
* :class:`~repro_torch.gateway.gateway.Gateway` — the submit path (cache →
  in-flight join → replica), with :class:`~repro_torch.gateway.metrics.
  GatewayMetrics` and the stdlib HTTP front-end
  (:func:`~repro_torch.gateway.http.serve_http`: ``/pagerank`` ``/topk``
  ``/ppr`` ``/healthz`` ``/metrics``).

The pool is supervised, and the tier degrades in defined steps instead of
hanging or lying: per-replica circuit breakers and health scores; a query
whose replica dies is replayed on a healthy one, byte-identical to the
fault-free run (every replica is seeded identically and a fresh replica's
key stream starts at wave 0), joined handles migrating with it; a crashed
replica restarts over the same shared index; overload, all breakers open
or draining raise :class:`~repro_torch.gateway.gateway.
GatewayOverloadError` with ``retry_after_s`` (HTTP 503 + ``Retry-After``);
``drain()`` finishes in-flight work, then closes; a certificate earned
under graph epoch *e* is refused once the gateway moved to *e+1*.

The waves run the port's kernels on the card: ``stitch_gather_rounds``
and ``frog_count`` each live wave, ``frog_superstep`` for
:meth:`Gateway.pagerank`, ``frog_segment_walk`` for the index build and
:meth:`Gateway.apply_mutations`' refresh, and the threefry draws.
``device=None`` means the card (raising without one); ``device="cpu"``
runs the plain PyTorch path.

Quickstart::

    from repro_torch.gateway import Gateway, serve_http

    with Gateway.open("graph.npz", replicas=2) as gw:
        r1 = gw.topk(k=10, epsilon=0.2, delta=0.1).result()
        r2 = gw.topk(k=10, epsilon=0.3, delta=0.1).result()  # cache hit:
        server = serve_http(gw)          # zero walks, dominated certificate
        print(server.url, gw.stats()["hit_rate"])
        server.close()
"""
from repro_torch.gateway.cache import CacheEntry, Certificate, ResultCache
from repro_torch.gateway.gateway import (Gateway, GatewayHandle,
                                         GatewayOverloadError)
from repro_torch.gateway.http import GatewayHTTPServer, serve_http
from repro_torch.gateway.metrics import GatewayMetrics
from repro_torch.gateway.pool import NoReplicaAvailable, ReplicaPool

__all__ = [
    "CacheEntry",
    "Certificate",
    "Gateway",
    "GatewayHTTPServer",
    "GatewayHandle",
    "GatewayMetrics",
    "GatewayOverloadError",
    "NoReplicaAvailable",
    "ReplicaPool",
    "ResultCache",
    "serve_http",
]
