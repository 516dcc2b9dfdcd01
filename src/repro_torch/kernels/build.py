"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Route (b) of the port's kernel rules: ``nvcc`` compiles each ``csrc/*.cu``
for ``sm_90a`` into an object file (all sources at once, in parallel),
links them into one shared library with a plain C interface, and ctypes
loads it. Nothing includes PyTorch's headers, so a build takes seconds.

The library lands under ``<repo>/build/kernels/<hash>/``, where the hash
covers the sources and the flags: an edited source builds anew, an
unchanged tree reuses the library. Nothing here runs at import time; the
first :func:`library` call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libfrogwild_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CFLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p, _c_int64, _c_int32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_c_float, _c_uint32 = ctypes.c_float, ctypes.c_uint32
# C entry points and their argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "fw_frog_step": [_c_void_p] * 8 + [_c_int64, _c_void_p],
    "fw_frog_superstep": [_c_void_p] * 4 + [_c_float] + [_c_void_p] * 3
    + [_c_int64, _c_void_p],
    "fw_frog_hop": [_c_void_p] * 2 + [_c_int32] * 2 + [_c_void_p] * 4
    + [_c_int32] * 2 + [_c_int64, _c_void_p],
    "fw_frog_superstep_stream_sorted": [_c_void_p] * 6 + [_c_float]
    + [_c_void_p] * 6 + [_c_int64] + [_c_int32] * 5 + [_c_void_p],
    "fw_frog_hop_stream_sorted": [_c_void_p] * 4 + [_c_int32]
    + [_c_void_p] * 6 + [_c_int64] + [_c_int32] * 5 + [_c_void_p],
    "fw_frog_segment_walk": [_c_void_p] * 2 + [_c_int32] * 2
    + [_c_void_p] * 4 + [_c_int32, _c_int64, _c_void_p],
    "fw_frog_segment_masks": [_c_void_p, _c_int32, _c_void_p, _c_int32,
                              _c_int32, _c_int64, _c_void_p],
    "fw_frog_count": [_c_void_p] * 2 + [_c_int64, _c_int64, _c_void_p],
    "fw_stitch_gather": [_c_void_p] * 5 + [_c_int64, _c_int32, _c_void_p],
    "fw_stitch_step": [_c_void_p] * 7 + [_c_int64, _c_int32, _c_void_p],
    "fw_stitch_gather_rounds": [_c_void_p] * 8 + [_c_int64] + [_c_int32] * 4
    + [_c_void_p],
    "fw_stitch_step_rounds": [_c_void_p] * 7 + [_c_int64] + [_c_int32] * 3
    + [_c_void_p],
    "fw_stitch_gather_local_rounds": [_c_void_p] * 8 + [_c_int64]
    + [_c_int32] * 4 + [_c_void_p],
    "fw_stitch_gather_local": [_c_void_p] * 5 + [_c_int64] * 3
    + [_c_int32, _c_void_p],
    "fw_stitch_step_local": [_c_void_p] * 7 + [_c_int64] * 3
    + [_c_int32, _c_void_p],
    "fw_frog_step_stream_sorted": [_c_void_p] * 11 + [_c_int64]
    + [_c_int32] * 5 + [_c_void_p],
    "fw_spmv_ell_slab": [_c_void_p] * 5 + [_c_int64, _c_int32, _c_void_p],
    "fw_threefry_bits": [_c_void_p] * 2 + [_c_int64] * 2 + [_c_void_p],
    "fw_threefry_randint": [_c_void_p] * 2 + [_c_int64] * 2
    + [_c_int32, _c_uint32, _c_uint32, _c_void_p],
    "fw_threefry_uniform": [_c_void_p] * 2 + [_c_int64] * 2 + [_c_void_p],
    "fw_threefry_bernoulli": [_c_void_p] * 2 + [_c_int64] * 2
    + [_c_float, _c_void_p],
    "fw_threefry_split": [_c_void_p] * 2 + [_c_int64] * 2 + [_c_void_p],
    "fw_threefry_fold_in": [_c_void_p, _c_int64, _c_void_p, _c_int64,
                            _c_int32, _c_uint32, _c_void_p, _c_int64,
                            _c_void_p],
    "fw_flash_attention": [_c_void_p] * 4 + [_c_int64] * 9 + [_c_int32] * 10
    + [_c_float, _c_int32, _c_float, _c_int32, _c_void_p],
    "fw_wkv6_scan": [_c_void_p] * 8 + [_c_int32, _c_int64] + [_c_int32] * 3
    + [_c_void_p],
    "fw_ssd_scan": [_c_void_p] * 8 + [_c_int32, _c_int64] + [_c_int32] * 4
    + [_c_void_p],
}

_LOCK = threading.Lock()
_LIB: List[ctypes.CDLL] = []       # the loaded library, once built
BUILD_INFO: Dict[str, object] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source at first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Runs the commands in parallel; returns their merged output and
    raises with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return outs


def _build(out_dir: Path) -> Path:
    nvcc = nvcc_path()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=out_dir.parent))
    try:
        t0 = time.perf_counter()
        objs = [tmp / (s.stem + ".o") for s in sources()]
        logs = _run_all([[nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(s),
                          "-o", str(o)] for s, o in zip(sources(), objs)])
        logs += _run_all([[nvcc, ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                           *map(str, objs)]])
        (tmp / "build.log").write_text("\n".join(logs))
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log="\n".join(
            logs), built=True)
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():   # lost a race: reuse
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Later calls return
    it without touching the sources: this runs before every launch."""
    if _LIB:
        return _LIB[0]
    with _LOCK:
        if _LIB:
            return _LIB[0]
        out_dir = BUILD_ROOT / source_hash()
        so = out_dir / LIB_NAME
        if not so.exists():
            so = _build(out_dir)
        else:
            BUILD_INFO.update(seconds=0.0, built=False,
                              log=(out_dir / "build.log").read_text()
                              if (out_dir / "build.log").exists() else "")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB.append(lib)
        return lib
