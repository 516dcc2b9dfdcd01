"""Generational batching of LM requests (port of
``repro/serving/scheduler.py``).

``max_batch`` sequence slots; the queue is drained in waves of at most
``max_batch`` requests. A wave's prompts are left-padded with ``eos_id``
and prefilled together, then decoded with ``serve_step`` under the keys
``fold_in(PRNGKey(0), step)`` until every request has met its budget or
emitted ``eos_id``. Scheduling is host logic around the fixed-shape
device step, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serving.decode import serve_step
from repro_torch.serving.prefill import prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchScheduler:
    """Single-device generational batching (per-wave prefill)."""

    def __init__(self, params: Transformer, cfg: ModelConfig,
                 max_batch: int = 4, max_len: int = 512, eos_id: int = 1):
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.finished: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self) -> List[Request]:
        """Drains the queue, one generation wave per ``max_batch``
        requests, and returns every finished request."""
        while self.queue:
            wave = [self.queue.pop(0) for _ in
                    range(min(self.max_batch, len(self.queue)))]
            self._run_wave(wave)
            self.finished.extend(wave)
        return self.finished

    def _run_wave(self, wave: List[Request]) -> None:
        dev = self.params.device
        B = len(wave)
        maxp = max(len(r.prompt) for r in wave)
        toks = np.full((B, maxp), self.eos_id, np.int32)
        for i, r in enumerate(wave):
            toks[i, -len(r.prompt):] = r.prompt        # left-pad
        logits, state = prefill(self.params, self.cfg,
                                torch.from_numpy(toks).to(dev), self.max_len)
        cur = torch.argmax(logits, -1).to(torch.int32)
        budget = max(r.max_new_tokens for r in wave)
        done = np.zeros(B, bool)
        key = prng.PRNGKey(0, dev)
        for step in range(budget):
            host = cur.tolist()
            for i, r in enumerate(wave):
                if not done[i]:
                    r.output.append(host[i])
                    if host[i] == self.eos_id or \
                            len(r.output) >= r.max_new_tokens:
                        done[i] = True
            if done.all():
                break
            cur, state = serve_step(self.params, state, cur, self.cfg,
                                    key=prng.fold_in(key, step))
        for r in wave:
            r.done = True
