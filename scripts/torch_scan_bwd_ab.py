#!/usr/bin/env python3
"""The chunked ``ssd_scan_bwd`` against the serial design it replaced, on
one card: the gradients, the times in turns, the serial kernel's stages,
the other scans' bytes and the near-cancelling leaves of a training step
against a float32 step.

    python3 scripts/torch_scan_bwd_ab.py OLD_CSRC [PART ...]

A one-off tool for one source: ``OLD_CSRC`` is the ``csrc`` directory of
commit 3c450df, the last with the serial ``ssd_scan_bwd`` (made with
``git archive 3c450df src/repro_torch/kernels/csrc | tar -x -C
build/parent``). Its ``fw_ssd_scan`` and ``fw_wkv6_scan`` and
``fw_wkv6_scan_bwd`` take this tree's arguments; its ``fw_ssd_scan_bwd``
takes no head groups (``OLD_SSD_BWD_ARGS``) and the serial design's
scratch, ``2·H·NR·B·S·n + NR·B·S·H + NR·B·H`` float32, NR = D / 32 row
blocks, D / 16 at n = 128; the stage variants patch lines that only
that source has, and ``build_old`` stops, naming the line, on any other
source. The script builds those four sources with ``nvcc`` into libraries
of their own (under ``build/scan_bwd_ab/``), and the old
``ssd_scan_bwd.cu`` twice more with one of its stages taken out.
``PART`` picks what runs (all by default):

* ``bytes``: ``ssd_scan`` (with and without chunk checkpoints),
  ``wkv6_scan`` (with) and ``wkv6_scan_bwd`` through ``ops`` against the
  old libraries on the same inputs (rwkv6-3b's heads, 40 of 64;
  zamba2-1.2b's, 64 of 64 with a state of 64; bf16 at 2 × 4,096 and
  float32 at 2 × 33 from a nonzero state): one line a call, ``equal=True``
  where every output byte matches.
* ``ab``: ``ssd_scan_bwd`` at zamba2-1.2b's heads, bf16 at 2 × 4,096 and
  1 × 32,768: each gradient's relative Frobenius error between the new and
  the old kernel, then both times with ``chip_smoke.py``'s
  ``time_ms_auto`` (CUDA events) in the order old, new, new, old, and
  each one's device ms by kernel from a ``torch.profiler`` trace of 10
  calls; the old kernel's variants ``no_pass_a`` (pass A's state steps
  left out) and ``no_step_sums`` (each step's shuffle and warp sums left
  out) timed beside it, so that the old kernel's time splits by stage
  (a variant computes garbage; only its time is read).
* ``near``: the training step's gradients at 1 × 1,024 (rwkv6-3b and
  zamba2-1.2b at full width and depth, random init from seed 0, bf16)
  through the kernels and through the plain scans, and zamba2-1.2b's also
  through the old ``ssd_scan_bwd``, each held against the same step in
  float32 through the kernels on ``chip_smoke.py``'s ``NEAR_CANCEL``
  leaves (``near_cancel_gate``).

Prints one line a reading, the card's name and power limit first. Needs
one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

OUT = os.path.join(REPO, "build", "scan_bwd_ab")
# the serial fw_ssd_scan_bwd's arguments: this tree's without the groups
OLD_SSD_BWD_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_int32, ctypes.c_int64]
                    + [ctypes.c_int32] * 4 + [ctypes.c_void_p])
SOURCES = {"ssd_scan_bwd.cu": "fw_ssd_scan_bwd", "ssd_scan.cu": "fw_ssd_scan",
           "wkv6.cu": "fw_wkv6_scan", "wkv6_bwd.cu": "fw_wkv6_scan_bwd"}
# the old ssd_scan_bwd.cu with one stage taken out: (pattern, replacement)
VARIANTS = {
    "no_pass_a": [("for (int q = 1; q < NSUB; ++q) {",
                   "for (int q = 1; q < 1; ++q) {")],
    "no_step_sums": [("scan_butterfly<4, ROUNDS>(gbr, cg);", ""),
                     ("for (int m = CG; m < 32; m <<= 1) {",
                      "for (int m = 32; m < 32; m <<= 1) {"),
                     ("gh = scan_warp_sum(gh);", "")],
}


def _build(path: str, csrc: str, name: str, entry: str):
    from repro_torch.kernels import build
    so = os.path.join(OUT, name + ".so")
    subprocess.run([build.nvcc_path(), *build.CFLAGS, "-I", csrc, "-shared",
                    "-o", so, path], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = (OLD_SSD_BWD_ARGS if entry == "fw_ssd_scan_bwd"
                   else build.SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


def build_old(csrc: str) -> dict:
    """The old sources' entry points by source name, and the old
    ``ssd_scan_bwd`` variants by variant name; built in parallel."""
    from concurrent.futures import ThreadPoolExecutor
    os.makedirs(OUT, exist_ok=True)
    jobs = {src: (os.path.join(csrc, src), src[:-3], entry)
            for src, entry in SOURCES.items()}
    text = open(os.path.join(csrc, "ssd_scan_bwd.cu")).read()
    for name, edits in VARIANTS.items():
        body = text
        for pat, new in edits:
            if pat not in body:
                raise RuntimeError(f"{name}: {pat!r} is not in the source")
            body = body.replace(pat, new)
        path = os.path.join(OUT, f"ssd_scan_bwd_{name}.cu")
        with open(path, "w") as f:
            f.write(body)
        jobs[name] = (path, f"ssd_scan_bwd_{name}", "fw_ssd_scan_bwd")
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(_build, p, csrc, n, e)
                for k, (p, n, e) in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def old_ssd_bwd(fn):
    """``ops._launch`` for ``ssd_scan_bwd`` through an old entry point
    ``fn``, with the old design's scratch in place of the new one and no
    head groups."""
    import torch
    from repro_torch.kernels import ops
    orig = ops._launch

    def launch(name, device, *args):
        if name != "ssd_scan_bwd":
            return orig(name, device, *args)
        B, S, H, D, n = args[15:20]
        nr = D // (16 if n == 128 else 32)
        part = torch.empty(2 * H * nr * B * S * n + nr * B * S * H
                           + nr * B * H, dtype=torch.float32, device=device)
        rc = fn(*args[:14], part.data_ptr(), *args[15:21], stream())
        if rc:
            raise RuntimeError(f"old ssd_scan_bwd: CUDA error {rc}")
        ops.LAUNCHES[name] += 1
    return launch


def part_bytes(cs, fns, dev) -> bool:
    """The other scans' outputs against the old libraries'."""
    import torch
    from repro_torch.kernels import ops
    ok = True
    for dtype, B, S in (("bfloat16", 2, 4_096), ("float32", 2, 33)):
        dt = getattr(torch, dtype)
        bf16 = int(dtype == "bfloat16")
        for kernel in ("ssd_scan_bwd", "wkv6_scan_bwd"):
            args, cots = cs.scan_bwd_inputs(kernel, B, S, dt, dev, seed=5)
            fwd = cs.SCAN_BWD_FWD[kernel]
            src = "ssd_scan.cu" if fwd == "ssd_scan" else "wkv6.cu"
            tail = ((B, S, 64, 64, 64) if fwd == "ssd_scan"
                    else (B, S, 40, 64))
            for ckpt in (True, False):
                if fwd == "wkv6_scan" and not ckpt:
                    continue
                new = cs.scan_forward(kernel, args, checkpoints=ckpt)
                old = [torch.empty_like(t) for t in new if t is not None]
                checked = (ops._ssd_operands if fwd == "ssd_scan"
                           else ops._wkv6_operands)(fwd, *args)
                rc = fns[src](*(t if t is None else t.data_ptr()
                                for t in checked), *(t.data_ptr()
                                                     for t in old[:2]),
                              old[2].data_ptr() if ckpt else None, *tail,
                              bf16, stream())
                assert rc == 0, rc
                torch.cuda.synchronize()
                equal = all(torch.equal(p, q) for p, q in
                            zip([t for t in new if t is not None], old))
                ok &= equal
                print(f"[scan_bwd_ab_bytes] kernel={fwd} dtype={dtype} "
                      f"B={B} S={S} checkpoints={ckpt} equal={equal}",
                      flush=True)
            if kernel != "wkv6_scan_bwd":
                continue
            ckpt = cs.scan_forward(kernel, args, checkpoints=True)[2]
            new = ops.wkv6_scan_bwd(*args, *cots, ckpt=ckpt, impl="cuda")
            with cs.patched(ops, "_launch", lambda orig: _via(
                    orig, "wkv6_scan_bwd", fns["wkv6_bwd.cu"])):
                old = ops.wkv6_scan_bwd(*args, *cots, ckpt=ckpt, impl="cuda")
            torch.cuda.synchronize()
            equal = all(torch.equal(p, q) for p, q in zip(new, old))
            ok &= equal
            print(f"[scan_bwd_ab_bytes] kernel=wkv6_scan_bwd dtype={dtype} "
                  f"B={B} S={S} equal={equal}", flush=True)
    return ok


def _via(orig, name, fn):
    """``ops._launch`` with ``name`` sent to the old entry point ``fn``."""
    def launch(n, device, *args):
        if n != name:
            return orig(n, device, *args)
        rc = fn(*args, stream())
        if rc:
            raise RuntimeError(f"old {name}: CUDA error {rc}")
    return launch


def traced_ms(cs, call, calls: int = 10) -> dict:
    """``{kernel name: [launches, device ms a launch]}`` of ``calls``
    calls' trace."""
    top = cs.device_busy_ms(lambda: [call() for _ in range(calls)],
                            by_kernel=True)[4]
    out = {}
    for name, n, ms in top:
        short = name.split("<")[0].split("(")[0].replace("void ", "")
        k, t = out.get(short, (0, 0.0))
        out[short] = [k + n, t + ms]
    return {k: [n, t / n] for k, (n, t) in out.items()}


def part_ab(cs, fns, dev) -> bool:
    """The new and old ``ssd_scan_bwd`` at the two shapes."""
    import json
    import torch
    from repro_torch.kernels import ops
    ok = True
    for B, S in ((2, 4_096), (1, 32_768)):
        args, cots = cs.scan_bwd_inputs("ssd_scan_bwd", B, S, torch.bfloat16,
                                        dev, seed=12)
        ckpt = cs.scan_forward("ssd_scan_bwd", args, checkpoints=True)[2]

        def new():
            return ops.ssd_scan_bwd(*args, *cots, ckpt=ckpt, impl="cuda")

        def old_with(fn):
            def call():
                with cs.patched(ops, "_launch",
                                lambda orig: old_ssd_bwd(fn)):
                    return new()
            return call

        old = old_with(fns["ssd_scan_bwd.cu"])
        got, again, want = new(), new(), old()
        torch.cuda.synchronize()
        rel = {k: cs.tensor_rel(a.float(), b.float())
               for k, a, b in zip(cs.SCAN_BWD_GRADS["ssd_scan_bwd"], got,
                                  want)}
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ok &= repeat and finite and max(rel.values()) <= 1e-2
        print(f"[scan_bwd_ab_grads] B={B} S={S} dtype=bfloat16 "
              f"rel_new_old={json.dumps(rel)} repeat_byte_equal={repeat} "
              f"finite={finite}", flush=True)
        del got, again, want
        reads = [cs.time_ms_auto(fn)[0] for fn in (old, new, new, old)]
        old_ms, new_ms = (reads[0] + reads[3]) / 2, (reads[1] + reads[2]) / 2
        nbytes, serial, chunked = cs.scan_bwd_work("ssd_scan_bwd", args,
                                                   cots)
        bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        chunked_ms = chunked / cs.TF32_FLOP_PER_S * 1e3
        print(f"[scan_bwd_ab_time] B={B} S={S} old_new_new_old_ms={reads} "
              f"old_ms={old_ms} new_ms={new_ms} new_over_old="
              f"{new_ms / old_ms} bound_ms={max(bytes_ms, chunked_ms)} "
              f"bytes_ms={bytes_ms} chunked_products_ms={chunked_ms} "
              f"serial_ops_ms={serial / cs.FP32_FLOP_PER_S * 1e3} "
              f"groups={ops.ssd_bwd_groups(B, -(-S // 32), 64)}",
              flush=True)
        for tag, fn in (("new", new), ("old", old),
                        *((v, old_with(fns[v])) for v in VARIANTS)):
            ms = cs.time_ms_auto(fn)[0] if tag in VARIANTS else None
            print(f"[scan_bwd_ab_stages] B={B} S={S} kernel={tag} "
                  f"events_ms={ms} by_kernel={json.dumps(traced_ms(cs, fn))}",
                  flush=True)
        del args, cots, ckpt
        cs.free_device_memory()
    return ok


def part_near(cs, fns, dev) -> bool:
    """The near-cancelling leaves against a float32 step."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.training.train_step import init_train_state
    ok = True
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        cfg = get_config(arch)
        params = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev)["params"]
        batch = SyntheticTokens(vocab_size=cfg.vocab_size,
                                seq_len=cs.RTRAIN["gate_seq"],
                                global_batch=1, seed=3).batch(0, device=dev)

        def near_grads(run):
            full = run()
            leaves = cs.near_cancel_leaves(cfg, full)
            out = {k: full[k].cpu() for k in leaves}
            del full
            cs.free_device_memory()
            return out

        paths = {"kernel": near_grads(lambda: cs.step_gradients(
            params, batch, cfg, False)[2])}
        with cs.plain_scans(cfg):
            paths["plain"] = near_grads(lambda: cs.step_gradients(
                params, batch, dataclasses.replace(cfg, attn_impl="torch"),
                False)[2])
        if cfg.family == "hybrid":
            with cs.patched(ops, "_launch", lambda orig: old_ssd_bwd(
                    fns["ssd_scan_bwd.cu"])):
                paths["old_kernel"] = near_grads(lambda: cs.step_gradients(
                    params, batch, cfg, False)[2])
        try:
            cs.near_cancel_gate(params, batch, cfg, dev, paths)
        except AssertionError as e:
            print(f"[scan_bwd_ab_near] arch={arch} failed: {e}", flush=True)
            ok = False
        del params, paths
        cs.free_device_memory()
    return ok


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    parts = sys.argv[2:] or ["bytes", "ab", "near"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    build.library()
    lines = build.BUILD_INFO.get("log", "").splitlines()
    for i, line in enumerate(lines):   # each entry's line and the next two
        if "ssd_bwd" in line and "Compiling entry" in line:
            for text in lines[i:i + 3]:
                print(f"[scan_bwd_ab_ptxas] {text.strip()}", flush=True)
    fns = build_old(sys.argv[1])
    dev = torch.device("cuda")
    ok = True
    if "bytes" in parts:
        ok &= part_bytes(cs, fns, dev)
    if "ab" in parts:
        ok &= part_ab(cs, fns, dev)
    if "near" in parts:
        ok &= part_near(cs, fns, dev)
    print(f"[scan_bwd_ab_done] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
