"""Mutate-while-serving on the PyTorch port (the twin of
``examples/mutate_while_serving.py``): top-k queries keep being answered
while three edge-mutation batches land. Each batch compacts a new CSR
epoch, refreshes only the invalidated walk segments, and commits the new
epoch without stopping the query in flight, which finishes on the epoch it
was admitted on.

The service half drives one ``FrogWildService``. The gateway half, as the
reference example has it, drives a two-replica ``Gateway`` with its result
cache: each batch is refreshed once, on the index both replicas share, and
the cached certificates of the old epoch are orphaned.

  PYTHONPATH=src python examples/torch_mutate_while_serving.py

It runs on the card; ``--device cpu`` runs the plain PyTorch path (about
10 s at the default 20,000 vertices; ``--n`` sets the size).
"""
import argparse
import time

import numpy as np

from repro_torch import (FrogWildService, Gateway, RuntimeConfig,
                         ServingConfig, ShardConfig)
from repro_torch.dynamic import MutationBatch
from repro_torch.graph import chung_lu_powerlaw


def _random_batch(g, rng, k=16):
    """k random edge inserts and k deletes of existing edges, none of
    which leaves a vertex without an out-edge."""
    ins = [(int(rng.integers(g.n)), int(rng.integers(g.n)))
           for _ in range(k)]
    dels, pending = set(), {}
    while len(dels) < k:
        v = int(rng.integers(g.n))
        succ = g.successors(v)
        if len(succ) - pending.get(v, 0) > 1:
            d = (v, int(succ[rng.integers(len(succ))]))
            if d not in dels:
                dels.add(d)
                pending[v] = pending.get(v, 0) + 1
    return MutationBatch.edges(insert=ins, delete=sorted(dels))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()

    print(f"Generating a {args.n}-vertex power-law graph…")
    g = chung_lu_powerlaw(n=args.n, avg_out_deg=10, seed=0)
    cfg = RuntimeConfig(
        runtime=ShardConfig(num_shards=1, seed=7),
        serving=ServingConfig(segments_per_vertex=8, segment_len=4,
                              build_shards=4, max_walks=4096,
                              max_queries=4, max_steps=32))
    serve_service(g, cfg, args.device)
    serve_gateway(g, cfg, args.device)


def serve_service(g, cfg, device):
    """The service half: one service, three epochs under a query."""
    rng = np.random.default_rng(42)
    print("\n— one FrogWildService —")
    with FrogWildService.open(g, cfg, device=device) as svc:
        print("Building the walk index (epoch 0)…")
        r0 = svc.topk(k=10, epsilon=0.4, delta=0.1).result()
        print(f"  epoch {r0.epoch} top-10: {r0.vertices.tolist()}")

        for _ in range(3):
            batch = _random_batch(svc.graph, rng)
            # admit a query, let it start, then mutate underneath it
            h = svc.topk(k=10, epsilon=0.4, delta=0.1)
            h.poll()

            t0 = time.perf_counter()
            report = svc.apply_mutations(batch)
            dt = time.perf_counter() - t0
            frac = report.segments_rebuilt / report.total_segments
            print(f"epoch {report.epoch}: {batch.size} mutations → "
                  f"{report.segments_rebuilt}/{report.total_segments} "
                  f"segments rebuilt ({frac:.1%}) in {dt * 1e3:.0f} ms")

            r_old = h.result()               # pinned to its admission epoch
            r_new = svc.topk(k=10, epsilon=0.4, delta=0.1).result()
            print(f"  in-flight query settled on epoch {r_old.epoch}; "
                  f"fresh query on epoch {r_new.epoch}")
            assert r_old.epoch == report.epoch - 1
            assert r_new.epoch == report.epoch

        stats = svc.serving_stats()
        print(f"Service after 3 epochs: graph_epoch={svc.graph_epoch} "
              f"retiring={svc.retiring_epochs} "
              f"waves on epoch {stats.epoch}: {stats.waves_run}")


def serve_gateway(g, cfg, device):
    """The gateway half: two replicas over one index, with the cache."""
    rng = np.random.default_rng(42)
    print("\n— a two-replica Gateway with its result cache —")
    with Gateway.open(g, cfg, replicas=2, device=device) as gw:
        print("Building the walk index (epoch 0)…")
        r0 = gw.topk(k=10, epsilon=0.4, delta=0.1).result()
        print(f"  epoch {r0.epoch} top-10: {r0.vertices.tolist()}")
        assert gw.topk(k=10, epsilon=0.4, delta=0.1).source == "cache"

        for _ in range(3):
            batch = _random_batch(gw.pool.graph, rng)
            # admit a query no certificate answers, let it start, then
            # mutate underneath it
            h = gw.topk(k=12, epsilon=0.4, delta=0.1)
            h.poll()

            t0 = time.perf_counter()
            report = gw.apply_mutations(batch)
            dt = time.perf_counter() - t0
            frac = report.segments_rebuilt / report.total_segments
            print(f"epoch {report.epoch}: {batch.size} mutations → "
                  f"{report.segments_rebuilt}/{report.total_segments} "
                  f"segments rebuilt ({frac:.1%}) in {dt * 1e3:.0f} ms, "
                  f"one refresh for both replicas")
            assert all(r.ensure_index() is gw.pool.index
                       for r in gw.pool.replicas)

            r_old = h.result()               # pinned to its admission epoch
            r_new = gw.topk(k=10, epsilon=0.4, delta=0.1).result()
            print(f"  in-flight query ({h.source}) settled on epoch "
                  f"{r_old.epoch}; fresh query on epoch {r_new.epoch}")
            assert r_old.epoch == report.epoch - 1
            assert r_new.epoch == report.epoch

        s = gw.stats()
        print(f"Gateway after 3 epochs: graph_epoch={s['graph_epoch']} "
              f"orphaned_certs={s['epoch_orphaned']} "
              f"cache_evictions={s['cache']['epoch_evictions']} "
              f"requests={s['requests']} hit_rate={s['hit_rate']:.2f}")


if __name__ == "__main__":
    main()
