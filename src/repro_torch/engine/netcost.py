"""Wire-byte cost models, what GraphLab's network counters measured (a
numpy copy of ``repro/engine/netcost.py``).

The paper's systems numbers (Fig. 1c, Fig. 8) are bytes on the wire:

* FrogWild: per superstep, each open (vertex, mirror) channel costs a sync
  message and each frog 4 bytes; closed channels cost nothing.
* GraphLab-PR: every iteration synchronizes every replica of every
  vertex, an all-gather of the float32 rank vector plus the same on the
  apply-side reduce.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SYNC_MSG_BYTES = 64            # one (vertex, mirror) sync: program + data
FROG_PAYLOAD_BYTES = 4         # one int32 vertex id per frog
RANK_BYTES = 4                 # f32 PageRank value


@dataclasses.dataclass(frozen=True)
class BytesReport:
    total: float
    per_step: np.ndarray

    def __str__(self) -> str:
        return f"{self.total / 1e6:.3f} MB total ({len(self.per_step)} steps)"


def frogwild_bytes_measured(sent_per_step: np.ndarray,
                            sync_msgs_per_step: np.ndarray) -> BytesReport:
    """Bytes from measured per-step counts of sent frogs and (active
    vertex, mirror) sync messages."""
    per_step = (
        sent_per_step.astype(np.float64) * FROG_PAYLOAD_BYTES
        + sync_msgs_per_step.astype(np.float64) * SYNC_MSG_BYTES
    )
    return BytesReport(total=float(per_step.sum()), per_step=per_step)


def frogwild_bytes_model(N: int, t: int, p_T: float, p_s: float, S: int,
                         avg_mirrors: float = 4.0) -> BytesReport:
    """Analytic expectation: ``N·(1 − p_T)^(τ+1)`` frogs alive at step τ,
    each on an active vertex that syncs ``p_s · avg_mirrors`` channels."""
    per_step = []
    for tau in range(t):
        alive = N * (1.0 - p_T) ** (tau + 1)
        syncs = alive * p_s * avg_mirrors
        per_step.append(alive * FROG_PAYLOAD_BYTES + syncs * SYNC_MSG_BYTES)
    arr = np.asarray(per_step)
    return BytesReport(total=float(arr.sum()), per_step=arr)


def pagerank_bytes_model(n: int, num_iters: int, S: int) -> BytesReport:
    """Dense rank synchronization: ``2·(S − 1)·n`` float32 values per
    iteration (the all-gather and the apply round trip)."""
    per_iter = 2.0 * (S - 1) * n * RANK_BYTES
    arr = np.full(num_iters, per_iter)
    return BytesReport(total=float(arr.sum()), per_step=arr)
