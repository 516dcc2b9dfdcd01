#!/usr/bin/env python3
"""The scans' no-grad forwards against an older source's: the same bytes,
and their times in turns on one card.

    python3 scripts/torch_scan_parent_ab.py OLD_CSRC

``OLD_CSRC`` is the ``csrc`` directory of a checkout whose ``wkv6.cu``
and ``ssd_scan.cu`` predate the chunk-checkpoint pointer (their entry
points take eight pointers, no ``ckpt``). The script builds those two
sources with ``nvcc`` into libraries of their own (under
``build/scan_parent/``) and runs them and this tree's ``ops.wkv6_scan`` /
``ops.ssd_scan`` without grad on the same inputs — rwkv6-3b's and
zamba2-1.2b's heads, bf16 at 1 × 32,768 and 2 × 4,096, float32 at 2 × 33
and 4 × 1 from a nonzero state — printing one line a call with
``equal=True`` where every output byte matches. Then, at the two bf16
shapes, it times both libraries' entry points (each called through
ctypes the same way, this tree's with a null checkpoint pointer) with
``chip_smoke.py``'s ``time_ms_auto`` (CUDA events over 50 calls, 5 above
10 ms), in the order old, new, new, old, and prints one line a kernel and
shape with the four reads and new / old of their means. Needs one CUDA
card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

SHAPES = (("bfloat16", 1, 32_768), ("bfloat16", 2, 4_096),
          ("float32", 2, 33), ("float32", 4, 1))


def build_old(csrc: str) -> dict:
    from repro_torch.kernels import build
    out = os.path.join(REPO, "build", "scan_parent")
    os.makedirs(out, exist_ok=True)
    fns = {}
    for src, entry in (("wkv6.cu", "fw_wkv6_scan"),
                       ("ssd_scan.cu", "fw_ssd_scan")):
        so = os.path.join(out, src[:-3] + ".so")
        subprocess.run([build.nvcc_path(), *build.CFLAGS, "-I", csrc,
                        "-shared", "-o", so, os.path.join(csrc, src)],
                       check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(so), entry)
        args = build.SIGNATURES[entry]
        fn.argtypes = args[:8] + args[9:]      # no checkpoint pointer
        fn.restype = ctypes.c_int
        fns[src] = fn
    return fns


def inputs(dtype, B: int, S: int, g, dev) -> dict:
    """Both scans' operands at the models' heads, from ``g``."""
    import torch
    dt = getattr(torch, dtype)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    r, k, v = (rn(B, S, 40, 64).to(dt) for _ in range(3))
    w = torch.exp(-torch.exp(rn(B, S, 40, 64) - 1))
    u, S0 = rn(40, 64), rn(B, 40, 64, 64)
    x = rn(B, S, 64, 64).to(dt)
    Bv, Cv = rn(B, S, 64).to(dt), rn(B, S, 64).to(dt)
    delta = torch.nn.functional.softplus(rn(B, S, 64) - 2)
    a = -torch.linspace(1, 16, 64, device=dev)
    h0 = rn(B, 64, 64, 64)
    return {"wkv6.cu": (r, k, v, w, u, S0), "ssd_scan.cu": (x, Bv, Cv, delta,
                                                            a, h0)}


def launcher(fn, src: str, ins, outs, ckpt_slot: bool, bf16: int, stream):
    """A call of entry point ``fn`` on ``ins`` into ``outs``; a new entry
    point gets a null checkpoint pointer."""
    B, S, H = ins[0].shape[:3]
    tail = (B, S, H, 64) if src == "wkv6.cu" else (B, S, H, 64, 64)
    ptrs = [t.data_ptr() for t in (*ins, *outs)] + (
        [None] if ckpt_slot else [])

    def call():
        rc = fn(*ptrs, *tail, bf16, stream)
        if rc:
            raise RuntimeError(f"{src}: CUDA error {rc}")
    return call


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    fns = build_old(sys.argv[1])
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    ok = True
    for dtype, B, S in SHAPES:
        ins = inputs(dtype, B, S, g, dev)
        with torch.no_grad():
            new = {"wkv6.cu": ops.wkv6_scan(*ins["wkv6.cu"]),
                   "ssd_scan.cu": ops.ssd_scan(*ins["ssd_scan.cu"])}
        bf16 = int(dtype == "bfloat16")
        calls = {}
        for src, entry in (("wkv6.cu", "fw_wkv6_scan"),
                           ("ssd_scan.cu", "fw_ssd_scan")):
            old = tuple(torch.empty_like(t) for t in new[src])
            run_old = launcher(fns[src], src, ins[src], old, False, bf16,
                               stream)
            run_old()
            torch.cuda.synchronize()
            equal = all(torch.equal(p, q) for p, q in zip(new[src], old))
            ok &= equal
            print(f"[scan_parent_bytes] source={src} dtype={dtype} B={B} "
                  f"S={S} equal={equal}", flush=True)
            mine = tuple(torch.empty_like(t) for t in new[src])
            calls[src] = (run_old, launcher(getattr(build.library(), entry),
                                            src, ins[src], mine, True, bf16,
                                            stream))
        if not bf16:
            continue
        for src, (run_old, run_new) in calls.items():
            reads = [cs.time_ms_auto(fn)[0]
                     for fn in (run_old, run_new, run_new, run_old)]
            old_ms = (reads[0] + reads[3]) / 2
            new_ms = (reads[1] + reads[2]) / 2
            print(f"[scan_parent_time] source={src} dtype={dtype} B={B} "
                  f"S={S} old_new_new_old_ms={reads} old_ms={old_ms} "
                  f"new_ms={new_ms} new_over_old={new_ms / old_ms}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
