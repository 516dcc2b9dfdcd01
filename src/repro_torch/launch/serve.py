"""Serving launcher: batched generation with the generational scheduler
(port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --requests 6 --max-new 16

``--arch`` is any architecture of the registry: the four dense ones, the
MoE olmoe-1b-7b and phi3.5-moe-42b-a6.6b (whose 41.9 B parameters outgrow
one card at full width; ``--smoke`` runs it), the attention-free rwkv6-3b,
the Mamba-2 hybrid zamba2-1.2b (whose decode carries a constant-size
state a layer and, for zamba2, one KV cache a shared-block site) and
llava-next-mistral-7b, served text only, as the reference's launcher
serves it. whisper-medium's decode needs encoder frames, which the
scheduler does not pass: it raises the reference's ``ValueError``. It
runs on the card unless
``--device`` says otherwise, at the architecture's full width unless
``--smoke`` asks for the reduced config.
Weights are random, from ``torch.Generator`` seed ``--seed``. The prompts
(request r: 3 + r % 5 tokens drawn by ``randint(fold_in(PRNGKey(seed +
1), r), …, 2, vocab)``) are the reference launcher's, token for token.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.serving import BatchScheduler, Request

MAX_LEN = 256


def make_requests(cfg: ModelConfig, n: int, seed: int, max_new: int
                  ) -> List[Request]:
    """The launcher's ``n`` requests: prompts of ``3 + r % 5`` tokens in
    ``[2, vocab)``, drawn on the host."""
    rng = prng.PRNGKey(seed + 1, "cpu")
    return [Request(rid=r, max_new_tokens=max_new, prompt=prng.randint(
        prng.fold_in(rng, r), (3 + r % 5,), 2, cfg.vocab_size).tolist())
        for r in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> List[Request]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of full width")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    params = init_params(cfg, args.seed, device=dev)
    sched = BatchScheduler(params, cfg, max_batch=args.max_batch,
                           max_len=MAX_LEN)
    for req in make_requests(cfg, args.requests, args.seed, args.max_new):
        sched.submit(req)
    t0 = time.perf_counter()
    done = sched.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    for r in done:
        print(f"[serve] req {r.rid}: {len(r.output)} tokens → "
              f"{r.output[:8]}…")
    print(f"[serve] {cfg.name} on {dev}: {len(done)} requests, {total} "
          f"tokens in {dt:.3f}s ({total / max(dt, 1e-9):.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
