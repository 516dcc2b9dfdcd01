#!/usr/bin/env python3
"""The walk-index builds and refreshes of two trees of the PyTorch port, in
turns, on one card.

    python3 scripts/torch_index_ab.py OLD_SRC NEW_SRC

``OLD_SRC`` and ``NEW_SRC`` are ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this one).
Each turn is a process of its own that imports ``repro_torch`` from one of
them, in the order old, new, new, old. A turn opens ``chip_smoke.py``'s
LiveJournal-scale graph (generated once, before the turns, and handed on
through a file) and ``chip_smoke.py``'s mutation batch (phase 18), and
reads each path three times after one warm-up: the dense build and the
streamed build (R = 16, L = 4, 8 build shards, ``_build_walk_index``),
the dense index refreshed in 4,096-row chunks and the 8 serving blocks
refreshed through the streamed kernel (``refresh_walk_index``). Each
read gives wall ms on the host clock (ending in a synchronize), and
under torch.profiler device-busy ms, kernels launched and the port's
kernels by name (``chip_smoke.py``'s ``device_busy_ms``). Each turn prints
one JSON line; the last line holds every turn. A turn that fails fails
the script. Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 3


def turn(src: str, graph_file: str) -> dict:
    sys.path[:0] = [os.path.abspath(src), REPO]
    import torch
    import chip_smoke as cs
    from repro_torch import RuntimeConfig
    from repro_torch.dynamic import apply_mutations, refresh_walk_index
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.kernels.frog_step_stream import blocked_csr_of
    from repro_torch.query.index import _build_walk_index, shard_walk_index
    dev = torch.device("cuda")
    arrays = torch.load(graph_file)
    g = CSRGraph(n=arrays["out_deg"].shape[0], **arrays).to(dev)
    cfg = RuntimeConfig().walk_index()
    stream_cfg = dataclasses.replace(cfg, step_impl="stream")
    blocked = blocked_csr_of(g)
    index = _build_walk_index(g, cfg)
    blocks = shard_walk_index(index, cs.SHARDS)
    g2, changed = apply_mutations(g, cs.mutation_window(g)[2])
    paths = {
        "build": lambda: _build_walk_index(g, cfg),
        "build_stream": lambda: _build_walk_index(g, stream_cfg,
                                                  blocked=blocked),
        "refresh": lambda: refresh_walk_index(index, g2, changed),
        "refresh_sharded_stream": lambda: refresh_walk_index(
            blocks, g2, changed, step_impl="stream")}
    out = {"src": src}
    for name, fn in paths.items():
        fn()
        walls = []
        for _ in range(READS):
            cs.sync()
            t0 = time.perf_counter()
            fn()
            cs.sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        reads = [cs.device_busy_ms(fn, by_kernel=True)[:4]
                 for _ in range(READS)]
        out[name] = {"wall_ms": walls,
                     "profiled_wall_ms": [r[0] for r in reads],
                     "device_busy_ms": [r[1] for r in reads],
                     "kernels": [r[2] for r in reads],
                     "port_kernels": reads[-1][3]}
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
        print("torch_index_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.graph import chung_lu_powerlaw
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    lj = cs.livejournal()
    g = chung_lu_powerlaw(lj.n, avg_out_deg=lj.avg_out_deg, theta=lj.theta,
                          seed=lj.seed)
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
