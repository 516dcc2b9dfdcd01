#!/usr/bin/env python3
"""The no-grad ``flash_attention`` forward of two trees of the PyTorch port,
in turns, on one card.

    python3 scripts/torch_attention_ab.py OLD_SRC NEW_SRC

``OLD_SRC`` and ``NEW_SRC`` are ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this one).
Each turn is a process of its own that imports ``repro_torch`` from one of
them, in the order old, new, new, old, and times ``ops.attention(...,
impl="cuda")`` under ``torch.no_grad()`` (the prefill and serving path,
which writes no LSE) at the LM phases' bf16 shapes: llama3.2-1b's causal
32/8 heads of 64, olmoe-1b-7b's 16 heads of 128 and llava's 32/8 of 128,
each at 1 × 32,768, and whisper's non-causal cross-attention, 32,768
queries over 1,500 keys. Each shape is read three times with
``chip_smoke.py``'s ``time_ms_auto`` (CUDA events over 50 calls, 5 above
10 ms) on the same seeded inputs. Each turn prints one JSON line; the
last line holds every turn. Then ``cuobjdump -sass`` of each tree's
kernel library compares the forward's kernels (``FORWARD_KERNELS``)
function by function and prints one JSON line, ``sass_identical`` by
function, so that a refactor of the sources can be told from a change
of the code the card runs. Needs one CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 3
# B, Hq, Hkv, Sq, Skv, D, causal
SHAPES = {"llama": (1, 32, 8, 32_768, 32_768, 64, True),
          "olmoe": (1, 16, 16, 32_768, 32_768, 128, True),
          "llava": (1, 32, 8, 32_768, 32_768, 128, True),
          "whisper_cross": (1, 16, 16, 32_768, 1_500, 64, False)}
# the forward's kernels by the names their mangled SASS functions hold
FORWARD_KERNELS = ("fa_wgmma_kernel", "flash_attention_kernel",
                   "fill_inf_kernel")


def turn(src: str) -> dict:
    sys.path[:0] = [os.path.abspath(src), REPO]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": src, "lib": build.library()._name}
    for name, (B, Hq, Hkv, Sq, Skv, D, causal) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(Sq + D)
        q, k, v = (torch.randn((B, h, n, D), generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for h, n in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))

        def call():
            with torch.no_grad():
                return ops.attention(q, k, v, causal=causal, impl="cuda")

        out[name] = [cs.time_ms_auto(call)[0] for _ in range(READS)]
        del q, k, v
    return out


def forward_sass(lib: str) -> dict:
    """{mangled name: SASS text} of the forward's kernels in ``lib``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function : "):
            name = line.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(body) for n, body in funcs.items()
            if any(k in n for k in FORWARD_KERNELS)}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    old, new = argv
    turns = []
    for src in (old, new, new, old):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", src],
            capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return 1
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    sass = [forward_sass(t["lib"]) for t in turns[:2]]
    print(json.dumps({"sass_identical": {
        n: sass[1].get(n) == body for n, body in sorted(sass[0].items())},
        "only_new": sorted(set(sass[1]) - set(sass[0]))}), flush=True)
    print(json.dumps({"turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
