"""Training launcher (port of ``repro/launch/train.py``).

Runs real optimization steps on the synthetic token stream, checkpoints
asynchronously every ``--ckpt-every`` steps, and resumes from the latest
checkpoint when one is there (kill it mid-run and relaunch to see):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 50 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --batch 2 --seq 4096 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --batch 2 --seq 4096 --steps 4

It runs on the card unless ``--device`` says otherwise, at the
architecture's full width unless ``--smoke`` asks for the reduced config,
with the reference launcher's flags and optimizer settings (warmup 10,
cosine to ``--steps``, no weight decay, ``remat``). The dense, MoE and
recurrent families train (rwkv6-3b and zamba2-1.2b through the scan
kernels' backward kernels on the card); the VLM and whisper need their
prefix embeddings or encoder frames in the batch, which the token stream
does not give, as in the reference. ``--partial-sync`` below 1 (the
p_s-lottery gradient sync over a data mesh, ``ROADMAP.md`` Queue 1 item
8) raises. Weights are
random, from ``torch.Generator`` seed ``--seed``; the batches are the
reference's byte for byte. A checkpoint holds the parameters by name and
the optimizer state (``repro_torch.checkpoint``'s format).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.training import (AdamWConfig, PartialSyncConfig,
                                  TrainStepConfig)
from repro_torch.training.train_step import init_train_state, make_train_step


def checkpoint_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """The train state as a checkpoint tree: the parameters by name, and
    the optimizer state."""
    params = {k: p.detach() for k, p in state["params"].named_parameters()}
    return {"params": params, "opt": state["opt"]}


def restore_train_state(directory: str, step: int, state: Dict[str, Any],
                        device: torch.device) -> Dict[str, Any]:
    """``state`` with its parameters (in place) and optimizer state from
    the checkpoint at ``step``."""
    tree = restore_checkpoint(directory, step, checkpoint_tree(state),
                              device=device)
    with torch.no_grad():
        for k, p in state["params"].named_parameters():
            p.copy_(tree["params"][k])
    return {"params": state["params"], "opt": tree["opt"]}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Runs the launcher; returns each step's metrics as floats."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--partial-sync", type=float, default=1.0,
                    help="p_s for FrogWild-style gradient sync (<1 enables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    tcfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                        weight_decay=0.0),
        remat=True,
        mode="partial_sync" if args.partial_sync < 1.0 else "gspmd",
        partial_sync=PartialSyncConfig(p_s=args.partial_sync,
                                       granularity="layer"),
    )
    state = init_train_state(cfg, args.seed, tcfg, device=dev)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_train_state(args.ckpt_dir, last, state, dev)
            start = last
            print(f"[train] resumed from step {last}")

    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    step_fn = make_train_step(cfg, tcfg)
    history: List[Dict[str, float]] = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = data.batch(i, device=dev)
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        if i % 10 == 0 or i == args.steps - 1:
            m = history[-1]
            print(f"[train] step {i:5d} loss={m['loss']:.4f} "
                  f"acc={m['accuracy']:.3f} gnorm={m['grad_norm']:.3f} "
                  f"({time.time() - t0:.1f}s)")
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save_async(i + 1, checkpoint_tree(state))
    if ckpt:
        ckpt.wait()
    print("[train] done")
    return history


if __name__ == "__main__":
    main()
