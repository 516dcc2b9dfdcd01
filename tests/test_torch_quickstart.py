"""``examples/torch_quickstart.py`` on the CPU at a small size: it runs as a
script, every frog stops somewhere (conservation), and the μ_20 it prints
is the one the same walk gives in this process, well above the
reference quickstart's healthy floor."""
import os
import pathlib
import re
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--n", "5000", "--frogs", "50000"]


def test_quickstart_twin_runs_on_the_cpu():
    # one thread a process: split over threads, the walk's ops stall on
    # their barriers when the test workers already fill the cores
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_quickstart.py"),
         *ARGS], capture_output=True, text=True, env=env, timeout=300,
        check=True).stdout
    stopped = re.search(r"frogs stopped:\s+(\d+) of (\d+)", out)
    assert stopped and stopped.group(1) == stopped.group(2) == "50000", out
    mass = float(re.search(r"mass captured @ top-20:\s+([0-9.]+)",
                           out).group(1))
    threads = torch.get_num_threads()
    sys.path.insert(0, str(REPO / "examples"))
    try:
        torch.set_num_threads(1)
        import torch_quickstart
        want = torch_quickstart.main(ARGS)
    finally:
        torch.set_num_threads(threads)
        sys.path.remove(str(REPO / "examples"))
    assert mass == float(f"{want:.4f}")
    assert mass >= 0.9
    assert "on cpu" in out
