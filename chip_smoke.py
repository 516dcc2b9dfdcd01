#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path once at LiveJournal scale (n = 4,847,571,
avg out-degree 14.2, θ = 2.2, seed 0; ``src/repro/configs/
frogwild_graphs.py``) through the entry points a user calls, and checks
every answer against its guarantee:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — the four CUDA kernels, compiled from ``csrc/`` with nvcc;
3. data     — the graph, generated on the host and moved to the card;
4. batch    — ``FrogWildService.pagerank(ε=0.1, δ=0.1, k=100)``, held to
              its Theorem 1 bound against 50 power iterations;
5. serving  — the walk index, 6 top-k and 2 PPR queries through
              ``QueryHandle.result()`` and one ``query_counts``, each held
              to its bound;
6. plain    — the batch run and one wave again through the plain PyTorch
              versions, byte-equal to the kernel path;
7. kernels  — each kernel at the main path's shapes against its plain
              version (byte-equal), with its time, bound and launches;
8. profile  — one batch run and one serving wave under torch.profiler:
              wall time against device-busy time (the idle share).

Launch counts are reset just before phase 4 and read just after phase 5.
The last line is ``{"ok": true, "device": {...}}``; any failed check or
launch raises and exits non-zero, as does a machine without CUDA.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

LJ = dict(n=4_847_571, avg_out_deg=14.2, theta=2.2, seed=0)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
REPS = 50


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after three warm-up calls)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sectors(idx) -> int:
    """Distinct 32-byte sectors of an int32 array touched at ``idx``."""
    import torch
    return int(torch.unique(idx.long() // 8).numel())


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("1 device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.BUILD_INFO.get("log", "").splitlines()
            if "registers" in ln]
    log("2 build", seconds=time.perf_counter() - t0,
        built=build.BUILD_INFO.get("built"), ptxas=json.dumps(regs))


def phase_data(dev):
    from repro_torch.graph import chung_lu_powerlaw
    t0 = time.perf_counter()
    g = chung_lu_powerlaw(LJ["n"], avg_out_deg=LJ["avg_out_deg"],
                          theta=LJ["theta"], seed=LJ["seed"])
    t_gen = time.perf_counter() - t0
    g = g.to(dev)
    log("3 data", n=g.n, nnz=g.nnz, gen_s=t_gen,
        csr_bytes=4 * (2 * g.n + 1 + g.nnz))
    return g


def sync():
    import torch
    torch.cuda.synchronize()


def phase_batch(svc, dev):
    import torch
    from repro_torch.core import mass_captured, power_iteration
    from repro_torch.query.engine import plan_query
    eps, delta, k = 0.1, 0.1, 100
    rc = svc.config
    plan = plan_query(k, eps, delta, p_T=rc.p_T,
                      max_steps=rc.serving.max_steps)
    sync()
    t0 = time.perf_counter()
    res = svc.pagerank(epsilon=eps, delta=delta, k=k)
    sync()
    t_pr = time.perf_counter() - t0
    N = res.num_frogs
    assert (N, plan.num_steps) == (400_000, 32), (N, plan.num_steps)
    assert int(res.counts.sum()) == N, "frogs not conserved"
    assert bool(torch.isfinite(res.pi_hat).all())
    t0 = time.perf_counter()
    pi = power_iteration(svc.graph, num_iters=50, p_T=rc.p_T)
    sync()
    t_pi = time.perf_counter() - t0
    mu_hat = float(mass_captured(res.pi_hat, pi, k))
    mu_opt = float(mass_captured(pi, pi, k))
    ok = mu_hat >= mu_opt - plan.epsilon_bound
    log("4 batch", N=N, t=plan.num_steps, pagerank_s=t_pr,
        power_iter_s=t_pi, mu_hat=mu_hat,
        mu_opt=mu_opt, epsilon_bound=plan.epsilon_bound,
        ok=ok)
    assert ok, "batch estimate misses its Theorem 1 bound"
    return res, pi


def phase_serving(svc, pi, dev):
    import torch
    from repro_torch import prng
    from repro_torch.core import mass_captured
    from repro_torch.query.engine import plan_query, query_counts
    g = svc.graph
    sync()
    t0 = time.perf_counter()
    index = svc.ensure_index()
    sync()
    t_idx = time.perf_counter() - t0
    assert index.endpoints.shape == (g.n, svc.config.serving
                                     .segments_per_vertex)
    hubs = [int(v) for v in torch.argsort(g.out_deg.cpu(),
                                          stable=True)[-2:]]
    t0 = time.perf_counter()
    handles = [svc.topk(k=10, epsilon=0.3) for _ in range(6)]
    handles += [svc.ppr(h, k=10, epsilon=0.3) for h in hubs]
    results = [h.result() for h in handles]
    t_serve = time.perf_counter() - t0
    mu_opt = float(mass_captured(pi, pi, 10))
    for h, r in zip(handles, results):
        if r.kind == "topk":
            mu = float(pi[torch.as_tensor(r.vertices, device=dev)].sum())
            assert mu >= mu_opt - r.epsilon_bound, (r.rid, mu, mu_opt,
                                                    r.epsilon_bound)
        else:
            assert int(r.vertices[0]) == h.request.source, r
            assert float(r.scores[0]) >= 0.10, r
    lat = [r.latency_s for r in results]
    waves = svc.scheduler.stats().waves_run
    log("5 serving", index_s=t_idx, queries=len(results),
        serve_s=t_serve, waves=waves,
        query_latency_s=json.dumps(lat),
        mu10=json.dumps([float(pi[torch.as_tensor(
            r.vertices, device=dev)].sum()) for r in results[:6]]),
        mu10_opt=mu_opt,
        eps_bound=results[0].epsilon_bound,
        ppr_scores=json.dumps([float(r.scores[0])
                               for r in results[6:]]))
    # the single-query path through the tallying stitch kernel
    plan = plan_query(10, 0.3, 0.1, p_T=svc.config.p_T,
                      max_steps=svc.config.serving.max_steps,
                      segments_per_vertex=index.segments_per_vertex,
                      segment_len=index.segment_len)
    sync()
    t0 = time.perf_counter()
    counts = query_counts(g, index, plan, prng.PRNGKey(7, dev),
                          p_T=svc.config.p_T)
    sync()
    t_q = time.perf_counter() - t0
    assert int(counts.sum()) == plan.num_walks
    mu = float(mass_captured(counts.float(), pi, 10))
    log("5 query_counts", walks=plan.num_walks, seconds=t_q,
        mu10=mu, ok=mu >= mu_opt - plan.epsilon_bound)
    assert mu >= mu_opt - plan.epsilon_bound
    return index, hubs


def wave_inputs(n, hubs, W, Q, dev):
    """A full wave like the scheduler's: W/Q walks per query slot, six
    uniform-start rows and two rows pinned at the hubs."""
    import torch
    per = W // Q
    qid = torch.arange(W, device=dev, dtype=torch.int32) // per
    uniform = qid < Q - len(hubs)
    start = torch.zeros(W, dtype=torch.int32, device=dev)
    for i, h in enumerate(hubs):
        start[qid == Q - len(hubs) + i] = h
    t_cap = torch.full((W,), 32, dtype=torch.int32, device=dev)
    return start, uniform, qid, t_cap


def phase_plain(svc, res, index, hubs, dev):
    import dataclasses
    import torch
    from repro_torch import KernelConfig, prng
    from repro_torch.query.engine import WaveSpec, build_wave_program
    plain_rc = dataclasses.replace(
        svc.config, kernel=KernelConfig(step_impl="torch",
                                        stitch_impl="torch",
                                        tally_impl="torch"))
    res_plain = svc.pagerank(epsilon=0.1, delta=0.1, k=100,
                             config=plain_rc)
    batch_eq = torch.equal(res.counts, res_plain.counts)
    g, sc = svc.graph, svc.config.serving
    W, Q = sc.max_walks, sc.max_queries
    outs = {}
    for impl in ("cuda", "torch"):
        spec = WaveSpec(n=g.n, R=index.segments_per_vertex,
                        L=index.segment_len,
                        q_max=sc.max_steps // index.segment_len, W=W, Q=Q,
                        p_T=svc.config.p_T, impl=impl, tally_impl=impl)
        outs[impl] = build_wave_program(spec)(
            index.endpoints, g.row_ptr, g.col_idx, g.out_deg,
            *wave_inputs(g.n, hubs, W, Q, dev), prng.PRNGKey(11, dev))
    wave_eq = torch.equal(outs["cuda"], outs["torch"])
    log("6 plain", batch_counts_equal=batch_eq, wave_counts_equal=wave_eq,
        wave_walks=int(outs["cuda"].sum()))
    assert batch_eq and wave_eq


def kernel_rows(svc, index, hubs, launches, dev):
    """Each kernel at the main path's shapes: kernel vs plain (byte-equal),
    times and bounds."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.query.engine import wave_prep
    g, sc = svc.graph, svc.config.serving
    n = g.n
    rows = []

    def row(name, source, replaces, kern, plain, nbytes, library=None):
        a, b = kern(), plain()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        err = max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                  for x, y in zip(a, b))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        r = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name], max_abs_err=err,
                 ms=time_ms(kern), plain_ms=time_ms(plain),
                 bound_ms=bound_ms(nbytes), bound_by="bytes",
                 library_ms=time_ms(library) if library else None)
        log("7 kernel", **{k: v for k, v in r.items()
                           if k not in ("source", "replaces", "route")})
        rows.append(r)

    # frog_step at the batch superstep's shape (N = 400,000 frogs)
    key = prng.PRNGKey(3, dev)
    k1, k2, k3 = prng.split(key, 3)
    N = 400_000
    pos = prng.randint(k1, (N,), 0, n)
    die = prng.bernoulli(k2, 0.15, (N,)).to(torch.int32)
    bits = prng.randint(k3, (N,), 0, 1 << 30)
    d = g.out_deg[pos.long()]
    edge = (g.row_ptr[pos.long()].long()
            + torch.remainder(bits, torch.clamp_min(d, 1)).long())
    nb = 16 * N + 4 * n + 32 * (2 * sectors(pos) + sectors(edge))
    row("frog_step", "src/repro_torch/kernels/csrc/frog_step.cu",
        "src/repro/kernels/frog_step.py:84",
        lambda: ops.frog_step(pos, die, bits, g.row_ptr, g.col_idx,
                              g.out_deg, n, impl="cuda"),
        lambda: kref.frog_step_ref(pos, die, bits, g.row_ptr, g.col_idx,
                                   g.out_deg, n), nb)

    # one wave's walks after its prologue, for the stitch rounds and tally
    W, Q, R = sc.max_walks, sc.max_queries, index.segments_per_vertex
    start, uniform, qid, t_cap = wave_inputs(n, hubs, W, Q, dev)
    wpos, q, s0 = wave_prep(g.row_ptr, g.col_idx, g.out_deg, start, uniform,
                            t_cap, prng.PRNGKey(5, dev), n=n,
                            L=index.segment_len, p_T=svc.config.p_T)
    slab = index.endpoints
    flat = slab.reshape(-1)
    sidx = wpos.long() * R + torch.remainder(s0, R).long()
    row("stitch_gather", "src/repro_torch/kernels/csrc/stitch.cu",
        "src/repro/kernels/stitch.py:161",
        lambda: ops.stitch_gather(wpos, s0, slab, impl="cuda"),
        lambda: kref.stitch_gather_ref(wpos, s0, slab),
        12 * W + 32 * sectors(sidx),
        library=lambda: torch.take(flat, sidx))
    stop = (q == 0).to(torch.int32)
    row("stitch_step", "src/repro_torch/kernels/csrc/stitch.cu",
        "src/repro/kernels/stitch.py:99",
        lambda: ops.stitch_step(wpos, stop, s0, slab, n, impl="cuda"),
        lambda: kref.stitch_step_ref(wpos, stop, s0, slab, n),
        16 * W + 4 * n + 32 * sectors(sidx))
    bins = (Q + 1) * n
    dest = wpos + qid * n
    dest_l = dest.long()
    row("frog_count", "src/repro_torch/kernels/csrc/frog_count.cu",
        "src/repro/kernels/frog_scatter.py:46",
        lambda: ops.frog_count(dest, bins, impl="cuda"),
        lambda: kref.frog_count_ref(dest, bins),
        4 * W + 4 * bins,
        library=lambda: torch.bincount(dest_l, minlength=bins))
    # frog_step at the index build's shape (R · n / build_shards frogs)
    C = -(-n // sc.build_shards) * R
    ipos = torch.randint(0, n, (C,), device=dev, dtype=torch.int32)
    ibits = torch.randint(0, 1 << 30, (C,), device=dev, dtype=torch.int32)
    zeros = torch.zeros_like(ipos)
    ms = time_ms(lambda: ops.frog_step(ipos, zeros, ibits, g.row_ptr,
                                       g.col_idx, g.out_deg, n, impl="cuda"),
                 reps=10)
    log("7 frog_step_index_shape", frogs=C, ms=ms)
    return rows


def device_busy_ms(fn) -> tuple:
    """``(wall ms, device-busy ms, kernels)`` of one ``fn()``: the union of
    the kernel intervals ``torch.profiler`` traced (CUPTI sees the ctypes
    launches too), against the host's clock."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e3, len(spans)


def phase_profile(svc):
    """Where one batch run and one serving wave spend their time."""
    for what, fn in (
            ("pagerank", lambda: svc.pagerank(epsilon=0.1, delta=0.1,
                                              k=100)),
            ("wave", lambda: (svc.topk(k=10, epsilon=0.3), svc.step()))):
        wall, busy, kernels = device_busy_ms(fn)
        log("8 profile", what=what, wall_ms=wall,
            device_busy_ms=busy if kernels else "not measured",
            idle_share=1 - busy / wall if kernels else "not measured",
            kernels=kernels)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "__init__.py")):
        print(f"chip_smoke: the port is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import FrogWildService, RuntimeConfig
    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    g = phase_data(dev)
    svc = FrogWildService.open(g, RuntimeConfig())
    ops.reset_launch_counts()
    res, pi = phase_batch(svc, dev)
    index, hubs = phase_serving(svc, pi, dev)
    launches = ops.launch_counts()
    log("launches", **launches)
    missing = [k for k, v in launches.items() if v < 1]
    assert not missing, f"kernels never launched on the main path: {missing}"
    phase_plain(svc, res, index, hubs, dev)
    rows = kernel_rows(svc, index, hubs, launches, dev)
    phase_profile(svc)
    svc.close()
    log("done", seconds=time.perf_counter() - t_all,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
