"""Train a small LM (reduced config) on the
synthetic stream with checkpoint/restart through the PyTorch port (the
twin of ``examples/train_lm.py``); kill it mid-run and relaunch with the
same ``--ckpt-dir`` to see it resume.

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 60

It runs the port's launcher (``python -m repro_torch.launch.train
--smoke``) on the reduced config of ``--arch`` (llama3.2-1b unless given;
olmoe-1b-7b, rwkv6-3b and zamba2-1.2b too). It runs on the card;
``--device cpu`` runs the plain PyTorch path. The checkpoints go to ``--ckpt-dir``, or to a temporary
directory that is removed at the end.
"""
import argparse
import subprocess
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--partial-sync", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", args.arch, "--smoke", "--steps", str(args.steps),
               "--ckpt-dir", args.ckpt_dir or tmp,
               "--partial-sync", str(args.partial_sync)]
        if args.device is not None:
            cmd += ["--device", args.device]
        rc = subprocess.call(cmd)
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
