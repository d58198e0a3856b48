"""Deterministic, shardable, resumable data pipeline.

The environment is offline, so the corpus source is a synthetic token stream
with C4-like statistics (Zipf-distributed unigrams + short-range structure so
models actually have something learnable).  Everything *around* the source is
production-real:

  * per-host sharding: host h of H reads only its slice of each global batch
  * deterministic skip-ahead: ``state = resume(step)`` is O(1) — a counter,
    not a replay — so checkpoint-restart is exact
  * sequence packing: documents are packed into fixed-length rows with EOS
    separators (no padding waste)
  * infinite iteration with per-epoch reshuffling via counter-based RNG
    (numpy's Philox keyed on (seed, step, row)) — no mutable RNG state to
    checkpoint beyond the step counter.

A numpy-only copy of the JAX package's ``data/pipeline.py``: the batches are
byte-identical to the reference's for the same ``DataConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 32
    seed: int = 0
    eos_id: int = 1
    mean_doc_len: int = 256
    zipf_a: float = 1.2
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLMStream:
    """Counter-based synthetic LM stream.  ``batch_at(step)`` is a pure
    function of (config, step) — the core of exact resume."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # fixed Zipf unigram table (small, regenerated identically everywhere)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._step = 0

    # ---------------------------------------------------------- core

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # counter-based: unique stream per (seed, step, global row index)
        gr = self.cfg.host_id * self.local_batch + row
        seq = np.random.SeedSequence([self.cfg.seed, step, gr])
        return np.random.Generator(np.random.Philox(seq))

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        # Zipf unigrams + short-range repetition structure (bigram-ish):
        toks = rng.choice(self.cfg.vocab, size=length, p=self._probs)
        # repeat-previous with p=0.2 at lag 1..4 gives learnable local stats
        lag = rng.integers(1, 5, size=length)
        rep = rng.random(length) < 0.2
        for i in range(1, length):
            if rep[i] and i - lag[i] >= 0:
                toks[i] = toks[i - lag[i]]
        return toks

    def _pack_row(self, rng: np.random.Generator) -> np.ndarray:
        """Pack EOS-separated documents into one seq_len row."""
        cfg = self.cfg
        row = np.empty(cfg.seq_len, dtype=np.int32)
        pos = 0
        while pos < cfg.seq_len:
            dlen = int(rng.exponential(cfg.mean_doc_len)) + 8
            dlen = min(dlen, cfg.seq_len - pos)
            doc = self._sample_doc(rng, dlen)
            row[pos : pos + dlen] = doc
            pos += dlen
            if pos < cfg.seq_len:
                row[pos] = cfg.eos_id
                pos += 1
        return row

    def batch_at(self, step: int) -> np.ndarray:
        """The local (per-host) batch for a given global step."""
        return np.stack(
            [self._pack_row(self._rng(step, r)) for r in range(self.local_batch)]
        )

    # ---------------------------------------------------------- iteration

    def resume(self, step: int) -> "SyntheticLMStream":
        self._step = step
        return self

    @property
    def step(self) -> int:
        return self._step

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        b = self.batch_at(self._step)
        self._step += 1
        return b


def build_stream(cfg: DataConfig) -> SyntheticLMStream:
    return SyntheticLMStream(cfg)
