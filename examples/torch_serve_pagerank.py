"""Serve PageRank queries through the PyTorch port's FrogWildService facade
(the twin of ``examples/serve_pagerank.py``).

Opens a :class:`~repro_torch.service.FrogWildService` over a generated
power-law graph — the service owns the walk-index lifecycle (build,
checkpoint round-trip, reuse) and the continuous-batching scheduler — then
submits concurrent global top-k and personalized-PageRank queries as
:class:`~repro_torch.service.QueryHandle` futures and drives them to
completion, printing one handle's anytime ``epsilon_bound`` refinement
along the way.

  PYTHONPATH=src python examples/torch_serve_pagerank.py

``--shards S`` serves from the slab as ``S`` per-shard blocks on the one
device, ``--slo-ms`` attaches a latency SLO to every request (deadline-
and queue-depth-aware admission), and ``--budget-walks`` gives every
query a walk budget beyond its Theorem 1 plan (early termination once the
requested (ε, δ) bound is certified).

``--replicas N`` serves the same workload through the **gateway** instead
— N service replicas over ONE walk index in device memory, routed by
EDF-charged queue depth, behind the (ε, δ)-aware result cache
(``--no-cache`` disables it) with in-flight joins. Repeating the stream
shows dominated certificates answering with zero new walks. ``--port P``
also mounts the stdlib HTTP front end (``/pagerank`` ``/topk`` ``/ppr``
``/healthz`` ``/metrics``; 0 = an ephemeral port on 127.0.0.1) and
requests it once:

  PYTHONPATH=src python examples/torch_serve_pagerank.py --replicas 2 \\
      --port 0

It runs on the card; ``--device cpu`` runs the plain PyTorch path (add
``--n 5000`` for a quick run).
"""
import argparse
import json
import tempfile
import time
import urllib.request

import numpy as np
import torch

from repro_torch import (FrogWildService, Gateway, RuntimeConfig,
                         ServingConfig, ShardConfig)
from repro_torch.core import normalized_mass_captured, power_iteration
from repro_torch.gateway import serve_http
from repro_torch.graph import chung_lu_powerlaw


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--segments", type=int, default=16, help="R per vertex")
    ap.add_argument("--segment-len", type=int, default=4, help="L steps")
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--shards", type=int, default=0,
                    help="serve from S per-shard slab blocks (0 = dense)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="attach this latency SLO to every request")
    ap.add_argument("--budget-walks", type=int, default=0,
                    help="per-query walk budget (> plan ⇒ anytime early "
                         "termination once the ε bound is certified)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through the gateway over N replicas "
                         "sharing one walk index (0 = direct service)")
    ap.add_argument("--cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the gateway's (ε, δ)-aware result cache "
                         "(--no-cache disables; gateway mode only)")
    ap.add_argument("--port", type=int, default=None,
                    help="also mount the HTTP front end on this port "
                         "(0 = ephemeral; gateway mode only)")
    args = ap.parse_args()

    print(f"Generating a {args.n}-vertex power-law graph (θ=2.2)…")
    g = chung_lu_powerlaw(n=args.n, avg_out_deg=12, seed=0)
    print(f"  n={g.n} edges={g.nnz}")

    with tempfile.TemporaryDirectory() as ckpt:
        config = RuntimeConfig(
            runtime=ShardConfig(num_shards=max(args.shards, 1)),
            serving=ServingConfig(
                segments_per_vertex=args.segments,
                segment_len=args.segment_len,
                build_shards=8, max_walks=8192, max_queries=8,
                max_steps=32, checkpoint_dir=ckpt,
            ),
        )
        if args.replicas:
            _serve_via_gateway(g, config, args)
            return

        svc = FrogWildService.open(g, config, device=args.device)

        t0 = time.perf_counter()
        index = svc.ensure_index()
        print(f"Walk index: {g.n}×{args.segments} length-{args.segment_len} "
              f"segments on {svc.device} in {time.perf_counter() - t0:.2f}s "
              f"(persisted via checkpoint/ under {ckpt})")
        if args.shards:
            block = index.blocks[0]
            print(f"Sharded slab: {index.num_shards} × "
                  f"[{index.shard_size}, {index.segments_per_vertex}] blocks "
                  f"({block.numel() * block.element_size() / 1e6:.2f} MB "
                  f"each, never reassembled); dispatch: host loop")

        hubs = torch.argsort(svc.graph.out_deg.cpu(), stable=True)[-3:]
        hubs = hubs.tolist()
        slo = (args.slo_ms / 1e3) or None
        budget = args.budget_walks or None
        handles = []
        for i in range(args.queries):
            if i % 3 == 2:
                h = svc.ppr(hubs[i % 3], k=10, epsilon=0.3, slo_s=slo,
                            num_walks=budget, allow_downgrade=True)
            else:
                h = svc.topk(k=10, epsilon=0.3, slo_s=slo,
                             num_walks=budget, allow_downgrade=True)
            handles.append(h)
            if not h.admitted:
                print(f"  q{h.rid:02d} REJECTED at admission: "
                      f"{h.decision.reason}")
            elif h.decision.downgraded:
                print(f"  q{h.rid:02d} downgraded to "
                      f"{h.decision.num_walks} walks (ε bound "
                      f"{h.decision.plan.epsilon_bound:.3f}) to fit "
                      f"{args.slo_ms:.0f}ms SLO")

        # Watch one future refine: its epsilon_bound tightens every wave.
        probe = next((h for h in handles if h.admitted), None)
        t0 = time.perf_counter()
        if probe is not None:
            while not probe.poll():
                p = probe.partial()
                print(f"  q{probe.rid:02d} partial: walks={p.walks_done} "
                      f"ε_bound={p.epsilon_bound:.3f}")
        results = svc.drain()
        dt = time.perf_counter() - t0
        print(f"Served {len(results)} queries in {dt:.2f}s "
              f"({len(results) / dt:.1f} queries/s; "
              f"{len(svc.scheduler.rejected)} rejected at admission)")

        print("Exact PageRank (50 power iterations) for reference…")
        pi = power_iteration(svc.graph, num_iters=50)
        for r in sorted(results, key=lambda r: r.rid):
            early = " early-stop" if r.early_stopped else ""
            if r.kind == "topk":
                est = torch.zeros(g.n, dtype=pi.dtype, device=pi.device)
                est[torch.as_tensor(r.vertices, device=pi.device)] = (
                    torch.as_tensor(r.scores, dtype=pi.dtype,
                                    device=pi.device))
                mass = float(normalized_mass_captured(est, pi, 10))
                print(f"  q{r.rid:02d} topk  waves={r.waves} "
                      f"walks={r.num_walks} ε_bound={r.epsilon_bound:.3f}"
                      f"{early} mass@10={mass:.3f} "
                      f"top5={list(map(int, r.vertices[:5]))}")
            else:
                print(f"  q{r.rid:02d} ppr   waves={r.waves} "
                      f"walks={r.num_walks} ε_bound={r.epsilon_bound:.3f}"
                      f"{early} source→top5="
                      f"{list(map(int, r.vertices[:5]))} "
                      f"scores={np.round(r.scores[:5], 4).tolist()}")
        svc.close()


def _serve_via_gateway(g, config, args):
    """The gateway: replicas sharing one index, dominance-checked cache,
    in-flight joins, metrics, and (optionally) the HTTP front end.

    Uses ε = 0.4 — feasible at max_steps=32, so finished certificates
    (≈ 0.392) dominate repeat requests; tighter targets are clamped wider
    by the Theorem 1 planner and would never hit again.
    """
    eps = 0.4
    hubs = torch.argsort(g.out_deg, stable=True)[-3:].tolist()
    t0 = time.perf_counter()
    with Gateway.open(g, config, replicas=args.replicas, cache=args.cache,
                      device=args.device) as gw:
        print(f"Gateway: {args.replicas} replicas over one "
              f"{g.n}×{args.segments} index on {gw.pool.device}, cache="
              f"{'on' if args.cache else 'off'} "
              f"(opened in {time.perf_counter() - t0:.2f}s)")

        def stream():
            return [gw.ppr(hubs[i % 3], k=10, epsilon=eps)
                    if i % 3 == 2 else gw.topk(k=10, epsilon=eps)
                    for i in range(args.queries)]

        t0 = time.perf_counter()
        first = stream()                    # live + in-flight joins
        for h in first:
            h.result()
        dt1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = stream()                   # dominated certificates: free
        for h in second:
            h.result()
        dt2 = time.perf_counter() - t0
        by = lambda hs, src: sum(h.source == src for h in hs)  # noqa: E731
        print(f"  pass 1: {len(first)} queries in {dt1:.2f}s "
              f"(live={by(first, 'live')} joined={by(first, 'joined')} "
              f"cache={by(first, 'cache')})")
        print(f"  pass 2: {len(second)} queries in {dt2 * 1e3:.1f}ms "
              f"(cache={by(second, 'cache')} — zero new walks)")
        s = gw.stats()
        print(f"  tier: qps={s['qps']} p50={s['p50_ms']}ms "
              f"p99={s['p99_ms']}ms hit_rate={s['hit_rate']:.2f} "
              f"join_rate={s['join_rate']:.2f}")
        for r in s["replicas"]:
            print(f"  replica {r['replica']}: waves={r['waves_run']} "
                  f"walks={r['walks_executed']} "
                  f"occupancy={r['wave_occupancy']:.2f}")

        if args.port is not None:
            with serve_http(gw, port=args.port) as srv:
                print(f"  HTTP front end at {srv.url} "
                      f"(/pagerank /topk /ppr /healthz /metrics)")
                for path in ("/healthz", f"/topk?k=5&epsilon={eps}"):
                    with urllib.request.urlopen(srv.url + path) as resp:
                        body = json.loads(resp.read())
                    print(f"  GET {path} -> {resp.status} "
                          f"{json.dumps(body)[:100]}")


if __name__ == "__main__":
    main()
