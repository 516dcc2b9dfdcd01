"""Quickstart on the PyTorch port: approximate the top-k PageRank of a
power-law graph through the FrogWildService facade and compare against
exact power iteration (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py

It runs on the card; ``--device cpu`` runs the plain PyTorch path (add
``--n 5000 --frogs 50000`` for a quick run).
"""
import argparse

import torch

from repro_torch import FrogWildService, RuntimeConfig, ShardConfig
from repro_torch.core import (exact_identification, normalized_mass_captured,
                              power_iteration, theory)
from repro_torch.graph import chung_lu_powerlaw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=50_000, help="vertices")
    ap.add_argument("--frogs", type=int, default=400_000, help="N")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")

    print(f"Generating a {args.n}-vertex power-law graph (θ=2.2)…")
    g = chung_lu_powerlaw(n=args.n, avg_out_deg=12, seed=0).to(dev)
    print(f"  n={g.n} edges={g.nnz} on {dev}")

    print("Exact PageRank (50 power iterations — the expensive way)…")
    pi = power_iteration(g, num_iters=50)

    k = 20
    # Remark 6: pick t and N from the analytic scaling
    mu_k = float(torch.topk(pi, k).values.sum())
    t = theory.suggested_steps(mu_k)
    print(f"FrogWild!: N={args.frogs} frogs, t={t} steps, p_s=0.7 "
          f"(partial synchronization)…")
    svc = FrogWildService.open(g, RuntimeConfig(
        num_frogs=args.frogs, num_steps=t, p_s=0.7, erasure="channel",
        runtime=ShardConfig(num_shards=16)), device=dev)
    res = svc.pagerank(seed=0)

    mass = float(normalized_mass_captured(res.pi_hat, pi, k))
    exact = float(exact_identification(res.pi_hat, pi, k))
    print(f"  frogs stopped:               {int(res.counts.sum())} of "
          f"{res.num_frogs}")
    print(f"  mass captured @ top-{k}:      {mass:.4f}")
    print(f"  exact identification @ {k}:   {exact:.3f}")
    top = torch.topk(res.pi_hat, 10).indices
    print(f"  estimated top-10 vertices: {top.tolist()}")
    true_top = torch.topk(pi, 10).indices
    print(f"  true      top-10 vertices: {true_top.tolist()}")
    return mass


if __name__ == "__main__":
    main()
