#!/usr/bin/env python3
"""Where the bf16 attention backward spends its time, on one card.

    python3 scripts/torch_attention_bwd_probe.py [variant ...]

Times ``ops.attention_bwd`` on its tensor-core route (random bf16 inputs,
the forward kernel's output and LSE, causal) at llama3.2-1b's heads (32/8
× 64) at 1 × 32,768 (``chip_smoke.py``'s row) and 2 × 4,096 (the
training step's), and at llava's heads (32/8 × 128) at 1 × 8,192: CUDA
events (ms a call, 5 calls after 2), and a ``torch.profiler`` trace of 3
calls giving each kernel's device ms a call (the Δ pass, the key-tile
pass, the query-tile pass) and each pass's TFLOP/s of the algorithm's
live pairs (four products in the key pass, three in the query pass),
beside SDPA's flash backward on the same inputs (forward and backward
less forward; ``enable_gqa``).

Then builds variants of ``csrc/fa_bwd_hopper.cuh`` side by side
(``nvcc``, one library each, under ``build/bwd_probe/``), prints
``ptxas``'s registers, stack and spills for each backward kernel, checks
each variant's gradients against the package's build (relative Frobenius
≤ 1e-2) and times it at the same shapes. A variant is a source pattern
and its replacement; a pattern that is not in the source raises, so a
variant never times the package's kernel by mistake:

* ``built``       — the header as it is;
* ``kNsM_qNsM``   — other tiles at head_dim 64: the key pass's and the
  query pass's consumer warpgroups and stages;
* ``d128_kNsM_qNsM`` — the same at head_dim 128.

With arguments, only the named variants are built. Prints one line a
reading. A variant that the card refuses to launch (its shared memory
over the 232,448 bytes an H100 block may opt into, say) or whose
gradients stray prints its line and the probe goes on; the exit code is
then 1, so that 0 means every variant launched and agreed. Needs one
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

HEADER = "fa_bwd_hopper.cuh"
D64 = "    return launch_cfg<64, 2, 4, 3, 4>(q, k, v, dout, tst, p, stream);"
D128 = "  return launch_cfg<128, 1, 4, 2, 3>(q, k, v, dout, tst, p, stream);"


def tiles(line: str, old: str, new: str):
    return [(line, line.replace(old, new))]


VARIANTS = {
    "built": [],
    "k2s6_q3s4": tiles(D64, "<64, 2, 4, 3, 4>", "<64, 2, 6, 3, 4>"),
    "k2s4_q2s4": tiles(D64, "<64, 2, 4, 3, 4>", "<64, 2, 4, 2, 4>"),
    "k2s4_q2s6": tiles(D64, "<64, 2, 4, 3, 4>", "<64, 2, 4, 2, 6>"),
    "k1s4_q3s4": tiles(D64, "<64, 2, 4, 3, 4>", "<64, 1, 4, 3, 4>"),
    "d128_k2s3_q2s3": tiles(D128, "<128, 1, 4, 2, 3>", "<128, 2, 3, 2, 3>"),
    "d128_k1s5_q2s3": tiles(D128, "<128, 1, 4, 2, 3>", "<128, 1, 5, 2, 3>"),
    "d128_k1s4_q1s4": tiles(D128, "<128, 1, 4, 2, 3>", "<128, 1, 4, 1, 4>"),
}
# B, Hq, Hkv, S, D
SHAPES = {"llama_32k": (1, 32, 8, 32_768, 64),
          "llama_train": (2, 32, 8, 4_096, 64),
          "llava_8k": (1, 32, 8, 8_192, 128)}
KERNELS = ("bwd_prep_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel")
PEAK = 989e12


def patched(text: str, edits, where: str) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{where}: pattern not in the source: {old!r}")
        text = text.replace(old, new)
    return text


def timed(fn, reps: int = 5) -> float:
    import torch
    for _ in range(2):
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


def device_ms(fn, calls: int = 3) -> dict:
    """``{kernel: device ms a call}`` of the backward's kernels in a trace
    of ``calls`` calls (a kernel the trace misses reads 0)."""
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
    out = {k: 0.0 for k in KERNELS}
    for e in events:
        for k in KERNELS:
            if e.get("cat") == "kernel" and k in e.get("name", ""):
                out[k] += float(e.get("dur", 0)) / 1e3 / calls
    return out


def ptxas_stats(log: str) -> dict:
    """``{kernel (template args): "regs=N stack=B spill_st=B spill_ld=B"}``
    of the backward's kernels in an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in KERNELS if k in mangled), None)
            if name:
                args = re.findall(r"ILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
                name += "<" + ",".join(args[0]) + ">" if args else ""
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name] = "stack={} spill_st={} spill_ld={}".format(*m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = f"regs={m.group(1)} " + out.get(name, "")
            name = None
    return out


def build_variants(names, out: str) -> dict:
    """``{variant: (library, ptxas stats)}``, built in parallel."""
    from repro_torch.kernels import build
    procs = []
    for tag in names:
        d = os.path.join(out, tag)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, HEADER), "w") as f:
            f.write(patched((build.CSRC / HEADER).read_text(),
                            VARIANTS[tag], tag))
        src = os.path.join(d, "flash_attention_bwd.cu")
        with open(src, "w") as f:
            f.write((build.CSRC / "flash_attention_bwd.cu").read_text())
        so = os.path.join(d, "libbwd.so")
        procs.append((tag, so, subprocess.Popen(
            [build.nvcc_path(), *build.CFLAGS, "-I", d, "-I",
             str(build.CSRC), "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag}:\n{log}")
        lib = ctypes.CDLL(so)
        fn = lib.fw_flash_attention_bwd
        fn.argtypes = build.SIGNATURES["fw_flash_attention_bwd"]
        fn.restype = ctypes.c_int
        libs[tag] = (lib, ptxas_stats(log))
    return libs


def inputs(shape, dev):
    import torch
    from repro_torch.kernels import ops
    B, Hq, Hkv, S, D = shape
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).bfloat16()
                   for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                             (B, Hq, S, D)))
    o, lse = ops._attention_kernel(q, k, v, True, None, 0, None, True)
    return q, k, v, o, lse, do


def sdpa_ms(q, k, v, do) -> float:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                              enable_gqa=True)

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        both = timed(lambda: torch.autograd.grad(fwd(), (qq, kk, vv), do))
        return both - timed(fwd)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def reading(tag: str, name: str, shape, args, fn) -> str:
    B, Hq, Hkv, S, D = shape
    pairs = S * (S + 1) // 2
    flop = 2 * B * Hq * pairs * D   # one product over the live pairs
    ms = timed(fn)
    dev = device_ms(fn)
    key, query = dev["dkdv_wgmma_kernel"], dev["dq_wgmma_kernel"]
    return (f"[bwd_probe] variant={tag} shape={name} B={B} Hq={Hq} "
            f"Hkv={Hkv} S={S} D={D} ms={ms} "
            f"tflop_per_s_5={5 * flop / ms / 1e9} "
            f"bound_ms={5 * flop / PEAK * 1e3} "
            f"prep_device_ms={dev['bwd_prep_kernel']} "
            f"key_pass_device_ms={key} query_pass_device_ms={query} "
            f"key_pass_tflop_per_s={4 * flop / key / 1e9 if key else 0} "
            f"query_pass_tflop_per_s={3 * flop / query / 1e9 if query else 0}")


def main() -> int:
    import torch
    from repro_torch.kernels import build, ops
    dev = torch.device("cuda")
    names = sys.argv[1:] or list(VARIANTS)
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[bwd_probe] card=" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.library()
    libs = build_variants(names, os.path.join(REPO, "build", "bwd_probe"))
    for tag, (_, stats) in libs.items():
        for kern, s in sorted(stats.items()):
            print(f"[bwd_probe] variant={tag} ptxas kernel={kern} {s}",
                  flush=True)
    package = build._LIB[0]
    failed = []
    for name, shape in SHAPES.items():
        args = inputs(shape, dev)
        want = ops.attention_bwd(*args)
        print(f"[bwd_probe] shape={name} sdpa_backward_ms="
              f"{sdpa_ms(args[0], args[1], args[2], args[5])}", flush=True)
        for tag, (lib, _) in libs.items():
            build._LIB[0] = lib
            try:
                got = ops.attention_bwd(*args)
                errs = [rel(a, b) for a, b in zip(got, want)]
                print(f"[bwd_probe] variant={tag} shape={name} "
                      f"rel_to_package={max(errs)} ok={max(errs) <= 1e-2}",
                      flush=True)
                if max(errs) > 1e-2:
                    failed.append((tag, name))
                print(reading(tag, name, shape, args,
                              lambda: ops.attention_bwd(*args)), flush=True)
            except RuntimeError as e:   # a tile that the card refuses
                print(f"[bwd_probe] variant={tag} shape={name} "
                      f"launch_failed={str(e)!r}", flush=True)
                failed.append((tag, name))
            finally:
                build._LIB[0] = package
        del args, want
        torch.cuda.empty_cache()
    if failed:
        print(f"[bwd_probe] failed={failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
