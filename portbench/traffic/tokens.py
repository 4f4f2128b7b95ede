"""Frozen copy of ``src/repro_torch/data/tokens.py`` (the port's
synthetic token stream), kept beside the benchmark so that a later change to the program
cannot change the traffic it is measured on. Copied as it stood, only
this header changed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenStream"]


class TokenStream:
    """``next_batch()`` gives ``{"tokens", "labels"}``, int32 numpy
    ``(batch, seq_len)``, labels the tokens shifted by one."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, noise: float = 0.05):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch_size
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        # affine next-token rule, coprime multiplier
        self.a = 5
        self.b = 131

    def next_batch(self):
        rng = self._rng
        first = rng.integers(0, self.vocab, (self.batch, 1))
        seq = [first]
        for _ in range(self.seq_len):
            nxt = (seq[-1] * self.a + self.b) % self.vocab
            noise_mask = rng.random((self.batch, 1)) < self.noise
            rand = rng.integers(0, self.vocab, (self.batch, 1))
            seq.append(np.where(noise_mask, rand, nxt))
        arr = np.concatenate(seq, axis=1).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
