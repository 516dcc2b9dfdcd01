#!/usr/bin/env python3
"""Where the chunked ``wkv6_scan_bwd`` spends its time, on one card.

    python3 scripts/torch_wkv6_bwd_probe.py

Builds variants of ``csrc/wkv6_bwd.cu`` side by side (``nvcc``, one
library each, under ``build/wkv6_bwd_probe/``), each with one stage taken
out, and times them through their C entry point on the same inputs:
rwkv6-3b's heads (40 of 64), bf16, at the training shape 2 × 4,096 and at
1 × 32,768, from a nonzero state with a nonzero final-state gradient.
Each time is ``chip_smoke.py``'s ``time_ms_auto`` (CUDA events over 50
calls, 5 above 10 ms); a ``torch.profiler`` trace misses ctypes launches
too often to split a call by kernel. The variants:

* ``full``       — the kernels as they are;
* ``dh_only``    — ``wkv6_bwd_chunk_kernel`` not launched: the chunk-end
  gradients and du's sum;
* ``chunk_only`` — ``wkv6_bwd_dh_kernel`` not launched: every chunk's
  gradients (reading G_e as the scratch holds it) and du's sum;
* ``nopairs``    — the chunk kernel without its sub-chunks' pair pass;
* ``noproducts`` — the chunk kernel without the tensor-core products of
  its third stage (dO·S_cᵀ, V·G_eᵀ, (K ∘ suf)·G_e, the cross parts and
  Qᵀ·dO; the compiler drops their operands' loads too).

Each edit is a source pattern and its replacement; a pattern that is not
in the source raises, so a variant never times the full kernel by
mistake. A variant computes garbage; only its time is read. Prints the
card's name and power limit, then one line a shape and variant. Needs one
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

OUT = os.path.join(REPO, "build", "wkv6_bwd_probe")
SHAPES = ((2, 4_096), (1, 32_768))
H, D = 40, 64
PRODUCTS = ("ssd_mma3_into<EXACT, false>(X1[q], fo, fs);",
            "ssd_mma3_into<EXACT, false>(Y1[q], fv, fg);",
            "ssd_mma3_into<false, false>(Z1[q], fk, fg);",
            "ssd_mma3_into<false, false>(XY[q], fm, fb);",
            "ssd_mma3_into<false, EXACT>(Z2[q], fq, fo);")
VARIANTS = {
    "full": [],
    "dh_only": [("  wkv6_bwd_chunk_kernel<N, T>\n      <<<",
                 "  if (false) wkv6_bwd_chunk_kernel<N, T>\n      <<<")],
    "chunk_only": [("  wkv6_bwd_dh_kernel<N, T>\n      <<<",
                    "  if (false) wkv6_bwd_dh_kernel<N, T>\n      <<<")],
    "nopairs": [("  if (wp < NSW) {\n    const int sub",
                 "  if (wp < 0) {\n    const int sub")],
    "noproducts": [(p, "") for p in PRODUCTS],
}


def patched(text: str, edits, where: str) -> str:
    """``text`` with each ``(pattern, replacement)`` applied (every
    occurrence); raises when a pattern is not in it."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{where}: pattern not in the source: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """One library a variant, built in parallel: ``{name: entry point}``."""
    from repro_torch.kernels import build
    src_dir = os.path.join(REPO, "src", "repro_torch", "kernels", "csrc")
    with open(os.path.join(src_dir, "wkv6_bwd.cu")) as f:
        text = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = os.path.join(OUT, f"wkv6_bwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(patched(text, edits, name))
        so = os.path.join(OUT, f"wkv6_bwd_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.CFLAGS, "-I", src_dir, "-shared",
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(so).fw_wkv6_scan_bwd
        fn.argtypes = build.SIGNATURES["fw_wkv6_scan_bwd"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    fns = build_variants()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    for B, S in SHAPES:
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=dev) * scale

        r, k, v = (rn(B, S, H, D).to(torch.bfloat16) for _ in range(3))
        lw = -torch.exp(rn(B, S, H, D) - 1)
        w, u, S0 = torch.exp(lw), rn(H, D, scale=0.1), rn(B, H, D, D)
        do, dS = rn(B, S, H, D).to(torch.bfloat16), rn(B, H, D, D)
        ckpt = ops._wkv6_kernel(*ops._wkv6_operands(
            "wkv6_scan", r, k, v, w, u, S0), checkpoints=True)[2]
        outs = [torch.empty_like(t) for t in (r, k, v, lw, u)]
        dS0 = torch.empty_like(S0)
        part = torch.empty(ops.wkv6_bwd_scratch(B, S, H, D),
                           dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in (r, k, v, lw, u, ckpt, do, dS, *outs,
                                       dS0, part)]
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(*ptrs, B, S, H, D, 1, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            ms, reps = cs.time_ms_auto(call)
            print(f"[wkv6_bwd_probe] variant={name} B={B} S={S} H={H} D={D}"
                  f" dtype=bfloat16 ms={ms} reps={reps}", flush=True)
        del r, k, v, lw, w, do, ckpt, outs, part
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
