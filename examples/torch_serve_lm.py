"""Serve a small LM with batched requests through the PyTorch port's
scheduler (the twin of ``examples/serve_lm.py``).

  PYTHONPATH=src python examples/torch_serve_lm.py --arch olmoe-1b-7b

It runs the port's launcher (``python -m repro_torch.launch.serve
--smoke``) on the reduced config of ``--arch`` (llama3.2-1b unless
given; the MoE olmoe-1b-7b and phi3.5-moe-42b-a6.6b too). It runs on the
card; ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--arch", args.arch, "--smoke",
           "--requests", str(args.requests)]
    if args.device is not None:
        cmd += ["--device", args.device]
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
