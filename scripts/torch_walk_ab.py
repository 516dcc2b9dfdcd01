#!/usr/bin/env python3
"""The batch walk's supersteps of two trees of the PyTorch port, in turns,
on one card.

    python3 scripts/torch_walk_ab.py OLD_SRC NEW_SRC

``OLD_SRC`` and ``NEW_SRC`` are ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this one).
Each turn is a process of its own that imports ``repro_torch`` from one of
them, in the order old, new, new, old. A turn opens ``chip_smoke.py``'s
LiveJournal-scale graph (generated once, before the turns, and handed on
through a file) and the streamed service's slab layout, and times the
walk of phase 12's ``frog_superstep`` and
``frog_superstep_stream_sorted`` rows: 400,000 frogs from ``pagerank``'s
key, reset and then t supersteps of the batch plan (``impl="cuda"``, and
``impl="stream"`` with its sorts), three reads each with
``chip_smoke.py``'s ``time_ms`` (CUDA events over 50 walks after 3). Each
turn prints one JSON line; the last line holds every turn. A turn that
fails fails the script. Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 3
FROGS = 400_000


def turn(src: str, graph_file: str) -> dict:
    sys.path[:0] = [os.path.abspath(src), REPO]
    import torch
    import chip_smoke as cs
    from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                             prng)
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.kernels import ops
    from repro_torch.query.engine import plan_query
    dev = torch.device("cuda")
    arrays = torch.load(graph_file)
    g = CSRGraph(n=arrays["out_deg"].shape[0], **arrays).to(dev)
    svc = FrogWildService.open(g, RuntimeConfig(
        kernel=KernelConfig(step_impl="stream")))
    blocked = svc.blocked_csr()
    rc = svc.config
    T = plan_query(100, 0.1, 0.1, p_T=rc.p_T,
                   max_steps=rc.serving.max_steps).num_steps
    k_init, k_loop = prng.split(prng.PRNGKey(rc.runtime.seed, dev))
    pos0 = prng.randint(k_init, (FROGS,), 0, g.n)
    step_keys = prng.split(k_loop, T)
    graph = (g.row_ptr, g.col_idx, g.out_deg, g.n)

    def walk(impl):
        reset = cs.walk_state(pos0, g.n, dev)

        def fn():
            state = reset()
            for s in range(T):
                ops.frog_superstep(*state, step_keys[s], rc.p_T, *graph,
                                   impl=impl, blocked=blocked)
        return fn

    out = {"src": src, "steps": T}
    for name, impl in (("frog_superstep", "cuda"),
                       ("frog_superstep_stream_sorted", "stream")):
        fn = walk(impl)
        out[name] = [cs.time_ms(fn) for _ in range(READS)]
    svc.close()
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
        print("torch_walk_ab: no CUDA device", file=sys.stderr)
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
