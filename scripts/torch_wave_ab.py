#!/usr/bin/env python3
"""The serving waves and ``query_counts`` of two trees of the PyTorch port,
in turns, on one card.

    python3 scripts/torch_wave_ab.py OLD_SRC NEW_SRC

``OLD_SRC`` and ``NEW_SRC`` are ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this one).
Each turn is a process of its own that imports ``repro_torch`` from one of
them, in the order old, new, new, old. A turn opens ``chip_smoke.py``'s
LiveJournal-scale graph (generated once, before the turns, and handed on
through a file), the dense service and the 8-shard service under
``sharded_dispatch="loop"``, and reads each path three times under
torch.profiler after one warm-up: one dense wave, one loop wave (a top-k
query and one ``step``, as ``chip_smoke.py`` phase 13), one degraded loop
wave and one degraded fused wave (8 shards, shard 3 evicted: through the
scheduler's ``_evict_shard`` where the tree has one, else by adding 3 to
its ``lost_shards``, which its waves read) and one ``query_counts`` at
phase 5's plan. Each read gives wall ms, device-busy
ms, kernels launched and the port's kernels by name (``chip_smoke.py``'s
``device_busy_ms``). Each turn prints one JSON line; the last line holds
every turn. A turn that fails fails the script. Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 3


def turn(src: str, graph_file: str) -> dict:
    sys.path[:0] = [os.path.abspath(src), REPO]
    import torch
    import chip_smoke as cs
    from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                             ShardConfig, prng)
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.query.engine import plan_query, query_counts
    dev = torch.device("cuda")
    arrays = torch.load(graph_file)
    g = CSRGraph(n=arrays["out_deg"].shape[0], **arrays).to(dev)
    dense = FrogWildService.open(g, RuntimeConfig())
    loop = FrogWildService.open(g, RuntimeConfig(
        runtime=ShardConfig(num_shards=cs.SHARDS),
        serving=ServingConfig(sharded_dispatch="loop")))
    degraded = {d: FrogWildService.open(g, RuntimeConfig(
        runtime=ShardConfig(num_shards=cs.SHARDS),
        serving=ServingConfig(sharded_dispatch=d)), index=loop.ensure_index())
        for d in ("loop", "fused")}
    for svc in degraded.values():
        sched = svc.scheduler
        if hasattr(sched, "_evict_shard"):
            sched._evict_shard(3, 0)
        else:
            sched.lost_shards.add(3)
    index, rc = dense.ensure_index(), dense.config
    plan = plan_query(10, 0.3, 0.1, p_T=rc.p_T,
                      max_steps=rc.serving.max_steps,
                      segments_per_vertex=index.segments_per_vertex,
                      segment_len=index.segment_len)
    paths = {
        "wave": lambda: (dense.topk(k=10, epsilon=0.3), dense.step()),
        "loop_wave": lambda: (loop.topk(k=10, epsilon=0.3), loop.step()),
        "degraded_loop_wave": lambda: (
            degraded["loop"].topk(k=10, epsilon=0.3),
            degraded["loop"].step()),
        "degraded_fused_wave": lambda: (
            degraded["fused"].topk(k=10, epsilon=0.3),
            degraded["fused"].step()),
        "query_counts": lambda: query_counts(g, index, plan,
                                             prng.PRNGKey(7, dev),
                                             p_T=rc.p_T)}
    out = {"src": src}
    for name, fn in paths.items():
        fn()
        cs.sync()
        reads = [cs.device_busy_ms(fn, by_kernel=True)[:4]
                 for _ in range(READS)]
        out[name] = {"wall_ms": [r[0] for r in reads],
                     "device_busy_ms": [r[1] for r in reads],
                     "kernels": [r[2] for r in reads],
                     "port_kernels": reads[-1][3]}
    for s in (dense, loop, *degraded.values()):
        s.close()
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1], argv[2])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv
    sys.path[:0] = [os.path.abspath(new), REPO]
    import torch
    if not torch.cuda.is_available():
        print("torch_wave_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.graph import chung_lu_powerlaw
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    g = chung_lu_powerlaw(cs.LJ["n"], avg_out_deg=cs.LJ["avg_out_deg"],
                          theta=cs.LJ["theta"], seed=cs.LJ["seed"])
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        graph_file = os.path.join(tmp, "graph.pt")
        torch.save({"row_ptr": g.row_ptr, "col_idx": g.col_idx,
                    "out_deg": g.out_deg}, graph_file)
        del g
        for src in (old, new, new, old):
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn", src,
                 graph_file], capture_output=True, text=True, timeout=900)
            if done.returncode != 0:
                print(done.stdout + done.stderr, file=sys.stderr)
                return 1
            line = done.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            turns.append(json.loads(line))
    print(json.dumps({"turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
