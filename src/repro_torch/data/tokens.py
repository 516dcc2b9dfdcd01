"""Deterministic synthetic LM token stream (port of
``repro/data/tokens.py``).

Step-indexed draws (a threefry ``fold_in`` of the step number) make the
pipeline stateless-resumable: after a restart from checkpoint step k,
batch k + 1 is the same bytes, with no iterator to persist. Per-host
sharding slices the global batch by process index. The stream is a
learnable mixture (an n-gram table read by random pattern ids), not
uniform noise, so a smoke run's loss falls.

The draws are ``repro_torch.prng``'s, bit for bit ``jax.random``'s, so
every batch equals the reference's byte for byte; on a CUDA device they
run through the threefry draw kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import prng
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_patterns: int = 64          # learnable n-gram pool size
    process_index: int = 0
    process_count: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.process_count:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.process_count} processes")
        return self.global_batch // self.process_count

    def _pattern_table(self, device: torch.device) -> torch.Tensor:
        key = prng.PRNGKey(self.seed, device)
        return prng.randint(key, (self.num_patterns, 8), 2, self.vocab_size)

    def batch(self, step: int, device: DeviceLike = None
              ) -> Dict[str, torch.Tensor]:
        """``{"tokens": int32[B, S], "labels": int32[B, S]}`` for this
        host at ``step``, on ``device`` (the card unless asked)."""
        dev = resolve_device(device)
        key = prng.fold_in(prng.PRNGKey(self.seed ^ 0x5EED, dev), step)
        key = prng.fold_in(key, self.process_index)
        B, S = self.local_batch, self.seq_len
        table = self._pattern_table(dev)
        n_slots = (S + 1 + 7) // 8
        pat = prng.randint(key, (B, n_slots), 0, self.num_patterns)
        seq = table[pat.long()].reshape(B, n_slots * 8)[:, : S + 1]
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
