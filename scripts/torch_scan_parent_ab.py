#!/usr/bin/env python3
"""The scans against an older source's, on one card: the forwards' bytes
and times, and ``wkv6_scan_bwd`` against the serial backward it replaced.

    python3 scripts/torch_scan_parent_ab.py OLD_CSRC [fwd] [bwd] [gate]

``OLD_CSRC`` is the ``csrc`` directory of an older checkout (``git
archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/<dir>``;
``build/`` is git-ignored and copied to the card). The script builds the
old sources it needs with ``nvcc`` into libraries of their own (under
``build/scan_parent/``) and calls them through ctypes beside this tree's.
The parts (all by default):

* ``fwd``: the old ``wkv6.cu`` and ``ssd_scan.cu`` (entry points with or
  without the chunk-checkpoint pointer, as the source declares them)
  against this tree's ``ops.wkv6_scan`` / ``ops.ssd_scan`` on the same
  inputs — rwkv6-3b's and zamba2-1.2b's heads, bf16 at 1 × 32,768 and 2
  × 4,096, float32 at 2 × 33 and 4 × 1 from a nonzero state: one line a
  call with ``equal=True`` where every output byte matches, without grad
  and, where the old source writes them, with the chunk checkpoints
  (outputs and checkpoints). Then, at the two bf16 shapes, both entry
  points timed (each through ctypes, this tree's with a null checkpoint
  pointer) with ``chip_smoke.py``'s ``time_ms_auto`` (CUDA events over 50
  calls, 5 above 10 ms) in the order old, new, new, old.
* ``bwd``: the old ``wkv6_bwd.cu``, which must be the serial backward
  (commit 24b08f4 or earlier: its entry point takes w and returns dw,
  with a ``du_part`` scratch; the script stops on another source),
  against this tree's chunked one at rwkv6-3b's heads, bf16 at 2 × 4,096
  and 1 × 32,768 and float32 at 2 × 33: each gradient's relative
  Frobenius error between the two (the new dlw against w ∘ the old dw, a
  product), both kernels' repeats byte-equal, then, at the bf16 shapes,
  both timed through their entry points in the order old, new, new, old.
* ``gate``: ``chip_smoke.py`` phase 25's bf16 step-gradient gate for
  rwkv6-3b (full width and depth, 1 × 1,024, every leaf's gradient
  through the kernels against the plain path's) through either backward
  — this tree's, and the old one as a patch of ``ops.wkv6_scan_bwd``
  returning w ∘ dw — in three states: the seed-0 initial weights, and
  those after phase 25's five AdamW steps (2 × 4,096, ``remat``) trained
  through the old and through the new backward. One line a state and
  backward: the ``u`` leaves past 5e-2, the worst ``u`` and the worst
  other leaf, and the other leaves past 5e-2; a report, no gate.

Prints the card's name and power limit, then one line a reading. Needs
one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

OUT = os.path.join(REPO, "build", "scan_parent")
FWD_SHAPES = (("bfloat16", 1, 32_768), ("bfloat16", 2, 4_096),
              ("float32", 2, 33), ("float32", 4, 1))
BWD_SHAPES = (("bfloat16", 2, 4_096), ("bfloat16", 1, 32_768),
              ("float32", 2, 33))
ENTRY = {"wkv6.cu": "fw_wkv6_scan", "ssd_scan.cu": "fw_ssd_scan",
         "wkv6_bwd.cu": "fw_wkv6_scan_bwd"}
# the serial fw_wkv6_scan_bwd: r, k, v, w, u, ckpt, dout, ds_last, dr, dk,
# dv, dw, du, ds0, part, du_part, B, S, H, D, bf16, stream
OLD_BWD_ARGS = ([ctypes.c_void_p] * 16 + [ctypes.c_int32, ctypes.c_int64]
                + [ctypes.c_int32] * 3 + [ctypes.c_void_p])


def entry_decl(text: str, entry: str) -> str:
    """The ``extern "C"`` declaration of ``entry`` in a source, up to its
    body."""
    at = text.index(f'extern "C" int {entry}(')
    return text[at:text.index("{", at)]


def build_old(csrc: str, srcs) -> dict:
    """``{source: (entry point, has a checkpoint pointer)}`` for each of
    ``srcs`` in ``csrc``, built in parallel."""
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for src in srcs:
        so = os.path.join(OUT, src[:-3] + ".so")
        procs[src] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.CFLAGS, "-I", csrc, "-shared", "-o",
             so, os.path.join(csrc, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for src, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{src}: nvcc failed\n{out}")
        with open(os.path.join(csrc, src)) as f:
            decl = entry_decl(f.read(), ENTRY[src])
        fn = getattr(ctypes.CDLL(so), ENTRY[src])
        if src == "wkv6_bwd.cu":
            if "du_part" not in decl or "void* dw" not in decl:
                raise SystemExit(f"{csrc}/{src} is not the serial backward "
                                 "(an entry point taking w, returning dw, "
                                 "with a du_part scratch)")
            fn.argtypes, ckpt = OLD_BWD_ARGS, True
        else:
            args = build.SIGNATURES[ENTRY[src]]
            ckpt = "ckpt" in decl
            fn.argtypes = args if ckpt else args[:8] + args[9:]
        fn.restype = ctypes.c_int
        fns[src] = (fn, ckpt)
    return fns


def card() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)


def fwd_inputs(dtype, B: int, S: int, g, dev) -> dict:
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


def fwd_launcher(fn, src: str, ins, outs, ckpt_slot: bool, ckpt, bf16: int,
                 stream):
    """A call of a forward entry point on ``ins`` into ``outs`` (``ckpt``
    its checkpoint buffer or None, where it has the slot)."""
    B, S, H = ins[0].shape[:3]
    tail = (B, S, H, 64) if src == "wkv6.cu" else (B, S, H, 64, 64)
    ptrs = [t.data_ptr() for t in (*ins, *outs)] + (
        [None if ckpt is None else ckpt.data_ptr()] if ckpt_slot else [])

    def call():
        rc = fn(*ptrs, *tail, bf16, stream)
        if rc:
            raise RuntimeError(f"{src}: CUDA error {rc}")
    return call


def part_fwd(old: dict, dev, stream) -> bool:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for dtype, B, S in FWD_SHAPES:
        ins = fwd_inputs(dtype, B, S, g, dev)
        checked = {"wkv6.cu": ops._wkv6_operands("wkv6_scan",
                                                 *ins["wkv6.cu"]),
                   "ssd_scan.cu": ops._ssd_operands("ssd_scan",
                                                    *ins["ssd_scan.cu"])}
        kern = {"wkv6.cu": ops._wkv6_kernel, "ssd_scan.cu": ops._ssd_kernel}
        bf16 = int(dtype == "bfloat16")
        calls = {}
        for src, (fn, slot) in old.items():
            with torch.no_grad():
                new = kern[src](*checked[src], checkpoints=slot)
            for with_ckpt in (False, True) if slot else (False,):
                mine = new if with_ckpt else kern[src](*checked[src],
                                                       checkpoints=False)
                outs = tuple(torch.empty_like(t) for t in mine[:2])
                ck = torch.empty_like(new[2]) if with_ckpt else None
                fwd_launcher(fn, src, ins[src], outs, slot, ck, bf16,
                             stream)()
                torch.cuda.synchronize()
                got = outs + ((ck,) if with_ckpt else ())
                want = mine[:2] + ((mine[2],) if with_ckpt else ())
                equal = all(torch.equal(p, q) for p, q in zip(want, got))
                ok &= equal
                print(f"[scan_parent_bytes] source={src} dtype={dtype} B={B}"
                      f" S={S} checkpoints={with_ckpt} equal={equal}",
                      flush=True)
            outs = tuple(torch.empty_like(t) for t in new[:2])
            mine = tuple(torch.empty_like(t) for t in new[:2])
            calls[src] = (
                fwd_launcher(fn, src, ins[src], outs, slot, None, bf16,
                             stream),
                fwd_launcher(getattr(build.library(), ENTRY[src]), src,
                             ins[src], mine, True, None, bf16, stream))
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
    return ok


def part_bwd(old_fn, dev, stream) -> bool:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    g = torch.Generator(device=dev).manual_seed(1)
    H, D = 40, 64
    new_fn = build.library().fw_wkv6_scan_bwd
    ok = True
    for dtype, B, S in BWD_SHAPES:
        dt = getattr(torch, dtype)
        bf16 = int(dtype == "bfloat16")

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=dev) * scale

        r, k, v = (rn(B, S, H, D).to(dt) for _ in range(3))
        lw = -torch.exp(rn(B, S, H, D) - 1)
        w, u, S0 = torch.exp(lw), rn(H, D, scale=0.1), rn(B, H, D, D)
        do, dS = rn(B, S, H, D).to(dt), rn(B, H, D, D, scale=0.1)
        ckpt = ops._wkv6_kernel(*ops._wkv6_operands(
            "wkv6_scan", r, k, v, w, u, S0), checkpoints=True)[2]

        def outs():
            return ([torch.empty_like(t) for t in (r, k, v, w, u)]
                    + [torch.empty_like(S0)])

        new, new2, old, old2 = outs(), outs(), outs(), outs()
        part = torch.empty(ops.wkv6_bwd_scratch(B, S, H, D),
                           dtype=torch.float32, device=dev)
        du_part = torch.empty(B, H, D, dtype=torch.float32, device=dev)

        def call(fn, lead, res, scratch):
            ptrs = [t.data_ptr() for t in (r, k, v, lead, u, ckpt, do, dS,
                                           *res)] + scratch

            def run():
                rc = fn(*ptrs, B, S, H, D, bf16, stream)
                if rc:
                    raise RuntimeError(f"wkv6_scan_bwd: CUDA error {rc}")
            return run

        runs = {"new": call(new_fn, lw, new, [part.data_ptr()]),
                "new2": call(new_fn, lw, new2, [part.data_ptr()]),
                "old": call(old_fn, w, old, [None, du_part.data_ptr()]),
                "old2": call(old_fn, w, old2, [None, du_part.data_ptr()])}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        repeat = {"new": all(map(torch.equal, new, new2)),
                  "old": all(map(torch.equal, old, old2))}
        old_l = list(old)
        old_l[3] = w * old[3]     # the old dw as the gradient of log w
        errs = {name: cs.tensor_rel(a.float(), b.float()) for name, a, b in
                zip(("dr", "dk", "dv", "dlw", "du", "dS0"), new, old_l)}
        lim = 1e-5 if dtype == "float32" else 1e-2
        ok &= all(repeat.values()) and max(errs.values()) <= lim
        print(f"[scan_parent_bwd] dtype={dtype} B={B} S={S} H={H} D={D} "
              f"repeat_byte_equal={repeat} "
              + " ".join(f"rel_{n}={e}" for n, e in errs.items())
              + f" limit={lim}", flush=True)
        if bf16:
            reads = [cs.time_ms_auto(runs[n])[0]
                     for n in ("old", "new", "new", "old")]
            old_ms = (reads[0] + reads[3]) / 2
            new_ms = (reads[1] + reads[2]) / 2
            print(f"[scan_parent_bwd_time] dtype={dtype} B={B} S={S} "
                  f"old_new_new_old_ms={reads} old_ms={old_ms} "
                  f"new_ms={new_ms} new_over_old={new_ms / old_ms}",
                  flush=True)
        del r, k, v, lw, w, do, ckpt, new, new2, old, old2, old_l, part
        torch.cuda.empty_cache()
    return ok


def old_bwd_route(old_fn):
    """A patch of ``ops.wkv6_scan_bwd`` through the old serial kernel: its
    dw returned as w ∘ dw, the gradient of log w, as autograd's ``exp``
    backward formed it on the old route."""
    import torch
    from repro_torch.kernels import ops

    def patch(orig):
        def fn(r, k, v, w, u, S0, do, dS_last=None, *, ckpt, log_w=None,
               impl="auto"):
            r, k, v, w, u, S0 = ops._wkv6_operands("wkv6_scan_bwd", r, k, v,
                                                   w, u, S0)
            B, S, H, D = r.shape
            do, ckpt = do.contiguous(), ckpt.contiguous()
            res = [torch.empty_like(t) for t in (r, k, v, w, u)]
            dS0 = torch.empty(B, H, D, D, device=r.device)
            du_part = torch.empty(B, H, D, device=r.device)
            ptrs = [t.data_ptr() for t in (r, k, v, w, u, ckpt, do)] + [
                None if dS_last is None else dS_last.contiguous().data_ptr()]
            rc = old_fn(*ptrs, *(t.data_ptr() for t in (*res, dS0)), None,
                        du_part.data_ptr(), B, S, H, D,
                        int(r.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"old wkv6_scan_bwd: CUDA error {rc}")
            res[3] = w * res[3]
            return (*res, dS0)
        return fn
    return patch


def part_gate(old_fn, dev) -> bool:
    import torch
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                      make_train_step)
    from repro_torch.training.train_step import init_train_state
    cfg = get_config("rwkv6-3b")
    old = old_bwd_route(old_fn)
    gb = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=1_024,
                         global_batch=1, seed=3).batch(0, device=dev)

    def small(grads):   # the vectors: u, the mixes, the norms' scales
        return {k: v.cpu() for k, v in grads.items() if v.dim() == 1}

    def params_after(tag, patch):
        state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if patch is None:
            return state["params"]
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=4_096,
                               global_batch=2, seed=0)
        step = make_train_step(cfg, TrainStepConfig(
            opt=AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100,
                            weight_decay=0.1), remat=True))
        losses = []
        for i in range(5):
            with cs.patched(ops, "wkv6_scan_bwd", patch):
                state, m = step(state, data.batch(i, device=dev))
            losses.append(float(m["loss"]))
        print(f"[scan_parent_gate_losses] state={tag} losses={losses}",
              flush=True)
        return state["params"]

    def this_tree(orig):
        return orig

    for tag, patch in (("initial", None), ("trained_old", old),
                       ("trained_new", this_tree)):
        params = params_after(tag, patch)
        with cs.plain_scans(cfg):
            plain = small(cs.step_gradients(params, gb, cfg, False)[2])
        for name, route in (("new", this_tree), ("old", old)):
            with cs.patched(ops, "wkv6_scan_bwd", route):
                got = small(cs.step_gradients(params, gb, cfg, False)[2])
            errs = {k: cs.tensor_rel(got[k].double(), plain[k].double())
                    for k in got}
            u = {k: e for k, e in errs.items() if k.endswith("time_mix.u")}
            rest = {k: e for k, e in errs.items() if k not in u}
            wu, wr = max(u, key=u.get), max(rest, key=rest.get)
            print(f"[scan_parent_gate] state={tag} backward={name} "
                  f"u_over_5e-2={sum(e > 0.05 for e in u.values())} "
                  f"u_worst={wu} {u[wu]} others_worst={wr} {rest[wr]} "
                  f"others_over_5e-2={sum(e > 0.05 for e in rest.values())}",
                  flush=True)
        del params, plain, got
        cs.free_device_memory()
    return True


def main() -> int:
    import torch
    csrc = sys.argv[1]
    parts = set(sys.argv[2:]) or {"fwd", "bwd", "gate"}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    card()
    srcs = (["wkv6.cu", "ssd_scan.cu"] if "fwd" in parts else []) + (
        ["wkv6_bwd.cu"] if parts & {"bwd", "gate"} else [])
    old = build_old(csrc, srcs)
    ok = True
    if "fwd" in parts:
        ok &= part_fwd({s: old[s] for s in ("wkv6.cu", "ssd_scan.cu")}, dev,
                       stream)
    if "bwd" in parts:
        ok &= part_bwd(old["wkv6_bwd.cu"][0], dev, stream)
    if "gate" in parts:
        ok &= part_gate(old["wkv6_bwd.cu"][0], dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
