"""Mutate-while-serving on the PyTorch port (the service half of
``examples/mutate_while_serving.py``): one ``FrogWildService`` keeps
answering top-k queries while three edge-mutation batches land. Each
batch compacts a new CSR epoch, refreshes only the invalidated walk
segments, and commits the new epoch without stopping the query in flight,
which finishes on the epoch it was admitted on.

The reference example drives a two-replica ``Gateway`` with a result
cache; the port's gateway comes later (ROADMAP.md Queue 1 item 12), so
this one drives the service those replicas wrap.

  PYTHONPATH=src python examples/torch_mutate_while_serving.py

It runs on the CPU (``device="cpu"``); pass ``--device cuda`` for the card.
"""
import argparse
import time

import numpy as np

from repro_torch import FrogWildService, RuntimeConfig, ServingConfig
from repro_torch import ShardConfig
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
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    print("Generating a 20k-vertex power-law graph…")
    g = chung_lu_powerlaw(n=20_000, avg_out_deg=10, seed=0)
    cfg = RuntimeConfig(
        runtime=ShardConfig(num_shards=1, seed=7),
        serving=ServingConfig(segments_per_vertex=8, segment_len=4,
                              build_shards=4, max_walks=4096,
                              max_queries=4, max_steps=32))
    rng = np.random.default_rng(42)

    with FrogWildService.open(g, cfg, device=args.device) as svc:
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
        print(f"\nService after 3 epochs: graph_epoch={svc.graph_epoch} "
              f"retiring={svc.retiring_epochs} "
              f"waves on epoch {stats.epoch}: {stats.waves_run}")


if __name__ == "__main__":
    main()
