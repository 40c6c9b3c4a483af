"""Synthetic LM token pipeline: deterministic, host-sharded, restartable.

Real corpora are not reachable offline; the stream is a seeded Zipf mixture
with enough local structure (bigram chains) to give non-trivial loss curves.
The API mirrors a production pipeline: each host owns a disjoint shard
(``host_id``/``num_hosts``), batches are indexed by step so a restart at
step k reproduces the identical batch k (checkpoint/resume correctness is
tested on this property).

A copy of the reference's ``data/tokens.py`` (numpy only, so the port keeps
its own): ``batch_at(step)`` is bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int                  # per-host batch
    seq_len: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    n_codebooks: int = 0        # musicgen-style (B, L, C) grids

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (restart-stable)."""
        rng = np.random.default_rng(
            (self.seed, self.host_id, self.num_hosts, int(step)))
        shape = (self.batch, self.seq_len + 1)
        if self.n_codebooks:
            shape = shape + (self.n_codebooks,)
        # Zipf body + bigram chain: token[t] depends on token[t-1] half the time
        z = rng.zipf(1.3, size=shape)
        toks = (z - 1) % self.vocab
        chain = rng.uniform(size=shape) < 0.5
        rolled = np.roll((toks * 31 + 7) % self.vocab, 1, axis=1)
        toks = np.where(chain, rolled, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
