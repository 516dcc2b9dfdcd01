#!/usr/bin/env python3
"""Where the two time-recurrence kernels spend their time, on one card.

    python3 scripts/torch_scan_probe.py

Times ``wkv6_scan`` at rwkv6-3b's shapes (40 heads of 64) and ``ssd_scan``
at zamba2-1.2b's (64 heads of 64, a state of 64), bf16 inputs, B = 1 at
S = 32,768 and 4,096 and B = 4 at S = 1, through ``ops``: CUDA events (ms
a call over 20 calls after 3; at S = 1 that is the launch path's time)
and the kernel's device ms a launch in a ``torch.profiler`` trace of 500
calls. Then builds variants of the two sources side by side (``nvcc``,
one library each, under ``build/scan_probe/``), each with one stage of
the kernels taken out, and times them through their C entry points on
the same 32k inputs (events) and at B = 4, S = 1 from a state (device
ms from a trace; a call shorter than one chunk runs each scan's serial
kernel, which no stage variant touches):

* ``full``        — the kernel as it is;
* ``wkv6.cu``: ``noproducer`` (no copies: the producer warp only passes
  the barriers), ``noloop`` (no serial step loop), ``noreadout`` (no
  output: the readout's FMAs, shuffles and stores left out), and
  ``pipelined`` (whole: the pipelined kernel at every length, the serial
  one never launched);
* ``ssd_scan.cu``: ``noproducts`` (no tensor-core products for G = C·Bᵀ,
  C·hᵀ and M·x; the decays and stores stay), ``nostate`` (no chunk-state
  pass: h is not updated), ``noreadout`` (no y written), ``noproducer``
  (no copies nor segment sums: the producer warp only passes the
  barriers), and ``skeleton`` (all four out: the barriers, the decays
  and the loop).

Each edit is a source pattern and its replacement; a pattern that is not
in the source raises, so a variant never times the full kernel by
mistake. A variant computes garbage; only its time is read. Prints one
line a reading. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

WKV6_ISSUE = "    auto issue = [&](int c) {\n"
WKV6_STORE = "    if (writer && out_prev) {\n"
SSD_ISSUE = ("    auto issue = [&](int c) {\n"
             "      const int64_t t0 = (int64_t)c * L;\n")
SSD_PREP = "    auto prep = [&](int c, bool last) {\n"
SSD_OFF = {
    "noproducts": [
        ("ssd_mma3<EXACT, EXACT>(acc[(k0 >> 3) & 1], fa, fb);", ""),
        ("ssd_mma3<EXACT, false>(inter[(k0 >> 3) & 1], fa, fb);", ""),
        ("ssd_mma3<false, EXACT>(intra, fa, fb);", "")],
    "nostate": [("    if (has_h) {\n      const float et",
                 "    if (mt < 0) {\n      const float et")],
    "noreadout": [("        if (i < steps) {\n          const float p",
                   "        if (i < 0) {\n          const float p")],
    "noproducer": [
        (SSD_ISSUE, SSD_ISSUE
         + "      if (c >= 0) { scan_cp_async_commit(); return; }\n"),
        (SSD_PREP, SSD_PREP
         + "      if (c >= 0) { scan_cp_async_wait_all(); scan_bar_arrive("
           "SSD_FULL + (c & 1), THREADS); return; }\n")],
}
VARIANTS = {
    "wkv6.cu": {
        "full": [],
        "noproducer": [(WKV6_ISSUE, WKV6_ISSUE
                        + "      if (c >= 0) { scan_cp_async_commit(); "
                        "return; }\n")],
        "noloop": [("      for (int s0 = 0; s0 < end; s0 += 4) {",
                    "      for (int s0 = 0; s0 < 0; s0 += 4) {")],
        "noreadout": [(WKV6_STORE, "    if (false) {\n")],
        "pipelined": [("  if (S < SCAN_T) {", "  if (false) {")],
    },
    "ssd_scan.cu": {"full": [], **SSD_OFF,
                    "skeleton": [e for v in SSD_OFF.values() for e in v]},
}
ENTRY = {"wkv6.cu": "fw_wkv6_scan", "ssd_scan.cu": "fw_ssd_scan"}


def patched(text: str, edits, where: str) -> str:
    """``text`` with each ``(pattern, replacement)`` applied; raises when
    a pattern is not in it."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{where}: pattern not in the source: {old!r}")
        text = text.replace(old, new)
    return text


def timed(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, kernel: str, calls: int = 500) -> str:
    """``"<device ms a launch> (<launches traced> of <calls>)"`` for the
    kernels named ``kernel…`` in a ``torch.profiler`` trace of ``calls``
    calls of ``fn``: the trace drops some launches made through ctypes,
    most at its start, so the mean is over the launches it holds."""
    import json
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    durs = [float(e.get("dur", 0)) for e in events
            if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    if not durs:
        return f"not_measured (0 of {calls})"
    return f"{sum(durs) / len(durs) / 1e3} ({len(durs)} of {calls})"


def inputs(B: int, S: int, dev):
    """(wkv6's operands, ssd's operands) at the two models' head shapes."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    H, D = 40, 64
    wkv = [randn(B, S, H, D).bfloat16() for _ in range(3)]
    wkv += [torch.exp(-torch.exp(randn(B, S, H, D) - 4)),
            randn(H, D) * 0.1, None]
    H, n = 64, 64
    ssd = [randn(B, S, H, D).bfloat16(), randn(B, S, n).bfloat16(),
           randn(B, S, n).bfloat16(),
           torch.nn.functional.softplus(randn(B, S, H) - 2),
           -torch.linspace(1, 16, H, device=dev), None]
    return wkv, ssd


def build_variants(out: str) -> dict:
    """``{(source, variant): C entry point}``, one library each, built in
    parallel."""
    from repro_torch.kernels import build
    os.makedirs(out, exist_ok=True)
    procs = []
    for src, variants in VARIANTS.items():
        for tag, edits in variants.items():
            text = patched((build.CSRC / src).read_text(), edits,
                           f"{src} {tag}")
            path = os.path.join(out, f"{tag}_{src}")
            with open(path, "w") as f:
                f.write(text)
            so = path[:-3] + ".so"
            procs.append((src, tag, so, subprocess.Popen(
                [build.nvcc_path(), *build.CFLAGS,
                 "-I", str(build.CSRC), "-shared", "-o", so, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for src, tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag} {src}:\n{log}")
        fn = getattr(ctypes.CDLL(so), ENTRY[src])
        fn.argtypes = build.SIGNATURES[ENTRY[src]]
        fn.restype = ctypes.c_int
        fns[(src, tag)] = fn
    return fns


def main() -> int:
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    for B, S in ((1, 32_768), (1, 4_096), (4, 1)):
        wkv, ssd = inputs(B, S, dev)
        if S == 1:   # from a state, as a decode step
            wkv[5] = ops.wkv6_scan(*wkv, impl="cuda")[1]
            ssd[5] = ops.ssd_scan(*ssd, impl="cuda")[1]
        calls = (("wkv6_scan", lambda: ops.wkv6_scan(*wkv, impl="cuda")),
                 ("ssd_scan", lambda: ops.ssd_scan(*ssd, impl="cuda")))
        print(f"[scan_probe] B={B} S={S} " + " ".join(
            f"{name}_ms={timed(fn)} {name}_device_ms="
            f"{device_ms(fn, name + '_kernel')}" for name, fn in calls),
            flush=True)
    fns = build_variants(os.path.join(REPO, "build", "scan_probe"))
    for B, S in ((1, 32_768), (4, 1)):
        (r, k, v, w, u, _), (x, Bv, Cv, dt, a, _) = inputs(B, S, dev)
        o, s_out = torch.empty_like(r), torch.randn(B, 40, 64, 64, device=dev)
        y, h_out = x.float(), torch.randn(B, 64, 64, 64, device=dev)
        # at S = 1 from a state (another buffer than the one written, so
        # every call starts from the same one)
        s_in, h_in = s_out.clone(), h_out.clone()
        s0, h0 = ((None, None) if S > 1 else
                  (s_in.data_ptr(), h_in.data_ptr()))
        stream = torch.cuda.current_stream().cuda_stream
        calls = {
            "wkv6.cu": lambda f: f(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0, o.data_ptr(), s_out.data_ptr(), None, B, S,
                40, 64, 1, stream),
            "ssd_scan.cu": lambda f: f(
                x.data_ptr(), Bv.data_ptr(), Cv.data_ptr(), dt.data_ptr(),
                a.data_ptr(), h0, y.data_ptr(), h_out.data_ptr(), None, B, S,
                64, 64, 64, 1, stream),
        }
        for src, variants in VARIANTS.items():
            for tag in variants:
                fn = fns[(src, tag)]
                reading = (f"ms={timed(lambda: calls[src](fn))}" if S > 1
                           else "device_ms=" + device_ms(
                               lambda: calls[src](fn),
                               ENTRY[src][3:] + "_kernel"))
                print(f"[scan_probe] source={src} variant={tag} B={B} "
                      f"S={S} {reading}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
