#!/usr/bin/env python3
"""Where the two time-recurrence kernels spend their time, on one card.

    python3 scripts/torch_scan_probe.py

Times ``wkv6_scan`` at rwkv6-3b's shapes (40 heads of 64) and ``ssd_scan``
at zamba2-1.2b's (64 heads of 64, a state of 64), bf16 inputs, B = 1 at
S = 32,768 and 4,096 and B = 4 at S = 1, through ``ops`` (CUDA events,
ms a call over 20 calls after 3). Then builds variants of the two
sources side by side (``nvcc``, one library each, under
``build/scan_probe/``), each with one stage taken out, and times them on
the same 32k inputs through their C entry points:

* ``full``      — the kernel as it is;
* ``nocompute`` — no serial step loop (the staging and the sums left);
* ``nowiden``   — the staged rows not widened to float32;
* ``nocopy``    — no chunk after the first copied in;
* ``noreduce``  — the warps' readout parts not summed nor stored.

A variant computes garbage; only its time is read. Prints one line a
reading. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

LOOP = "    for (int s = 0; s < steps; ++s) {"
VARIANTS = {
    "full": [],
    "nocompute": [(LOOP, "    for (int s = 0; s < 0; ++s) {")],
    "nowiden": [("    scan_widen(", "    if (0) scan_widen(")],
    "nocopy": [("    if (t0 + SCAN_T < S) ", "    if (0) ")],
    "noreduce": [("y = 0.f;\n", "y = 0.f; break;\n"),
                 ("acc = 0.f;\n#pragma unroll\n      for (int p",
                  "acc = 0.f; break;\n#pragma unroll\n      for (int p")],
}
ENTRY = {"wkv6.cu": "fw_wkv6_scan", "ssd_scan.cu": "fw_ssd_scan"}


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
    """``{(variant, source): C entry point}``, one library each, built in
    parallel."""
    from repro_torch.kernels import build
    os.makedirs(out, exist_ok=True)
    procs = []
    for tag, edits in VARIANTS.items():
        for src in ENTRY:
            text = (build.CSRC / src).read_text()
            for old, new in edits:
                text = text.replace(old, new)
            path = os.path.join(out, f"{tag}_{src}")
            with open(path, "w") as f:
                f.write(text)
            so = path[:-3] + ".so"
            procs.append((tag, src, so, subprocess.Popen(
                [build.nvcc_path(), *build.CFLAGS, "-I", str(build.CSRC),
                 "-shared", "-o", so, path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for tag, src, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag} {src}:\n{log}")
        fn = getattr(ctypes.CDLL(so), ENTRY[src])
        fn.argtypes = build.SIGNATURES[ENTRY[src]]
        fn.restype = ctypes.c_int
        fns[(tag, src)] = fn
    return fns


def main() -> int:
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    for B, S in ((1, 32_768), (1, 4_096), (4, 1)):
        wkv, ssd = inputs(B, S, dev)
        print(f"[scan_probe] B={B} S={S} wkv6_scan_ms="
              f"{timed(lambda: ops.wkv6_scan(*wkv, impl='cuda'))} "
              f"ssd_scan_ms={timed(lambda: ops.ssd_scan(*ssd, impl='cuda'))}",
              flush=True)
    fns = build_variants(os.path.join(REPO, "build", "scan_probe"))
    B, S = 1, 32_768
    (r, k, v, w, u, _), (x, Bv, Cv, dt, a, _) = inputs(B, S, dev)
    o, s_out = torch.empty_like(r), torch.empty(B, 40, 64, 64, device=dev)
    y, h_out = x.float(), torch.empty(B, 64, 64, 64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for tag in VARIANTS:
        f_wkv, f_ssd = fns[(tag, "wkv6.cu")], fns[(tag, "ssd_scan.cu")]
        ms_wkv = timed(lambda: f_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None, o.data_ptr(), s_out.data_ptr(), B, S, 40,
            64, 1, stream))
        ms_ssd = timed(lambda: f_ssd(
            x.data_ptr(), Bv.data_ptr(), Cv.data_ptr(), dt.data_ptr(),
            a.data_ptr(), None, y.data_ptr(), h_out.data_ptr(), B, S, 64,
            64, 64, 1, stream))
        print(f"[scan_probe] variant={tag} B={B} S={S} wkv6_scan_ms={ms_wkv} "
              f"ssd_scan_ms={ms_ssd}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
