"""Synthetic LM token pipeline (the reference's ``data/tokens.py``):
deterministic, sharded by host, no file I/O.

The numpy stream is the reference's, so both packages get identical tokens
from one seed: a Zipf unigram draw with short Markov repeats.  Batches are
int32 torch tensors on ``device`` (None = CUDA).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    host_id: int = 0
    num_hosts: int = 1
    seed: int = 0
    device: object = None

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step`` (counter-based; replayable):
        ``tokens`` and ``labels`` int32[host_batch, seq_len]."""
        dev = resolve_device(self.device)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, t = self.host_batch, self.seq_len
        # Zipf-ish unigrams over the vocab.
        u = rng.zipf(1.3, size=(b, t + 1))
        toks = (u % self.vocab).astype(np.int32)
        # Inject Markov structure: with p=0.5, next token = f(current).
        repeat = rng.random((b, t)) < 0.5
        nxt = (toks[:, :-1] * 31 + 7) % self.vocab
        toks[:, 1:] = np.where(repeat, nxt, toks[:, 1:])
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(
                toks[:, :-1])).to(dev),
            "labels": torch.from_numpy(np.ascontiguousarray(
                toks[:, 1:])).to(dev),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
