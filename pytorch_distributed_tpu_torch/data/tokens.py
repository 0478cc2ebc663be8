"""Token-sequence datasets for LM training
(``pytorch_distributed_tpu/data/tokens.py``): the same sequences for the
same index as the JAX package's.

A sample is one fixed-length ``[L] int32`` sequence; the trainer builds
labels and weights at collate time (``train.lm.shift_labels``).
"""

from __future__ import annotations

import numpy as np


class TokenArrayDataset:
    """Non-overlapping ``seq_len`` windows over a flat token array (a
    ``np.memmap`` of a packed corpus works; nothing is copied until a
    window is read)."""

    def __init__(self, tokens, seq_len: int):
        self.tokens = tokens
        self.seq_len = int(seq_len)
        if self.seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        self._n = len(tokens) // self.seq_len
        if self._n == 0:
            raise ValueError(
                f"token array ({len(tokens)}) shorter than seq_len {seq_len}")

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> np.ndarray:
        lo = int(i) * self.seq_len
        return np.asarray(self.tokens[lo:lo + self.seq_len], np.int32)


class SyntheticTokens:
    """Deterministic fake token sequences, seeded per index; token 0 (the
    pad id of ``shift_labels``) never appears."""

    def __init__(self, size: int, seq_len: int, vocab_size: int, seed: int = 0):
        self.size = int(size)
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab_size)
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> np.ndarray:
        r = np.random.default_rng([self.seed, int(i)])
        return r.integers(1, self.vocab_size, self.seq_len).astype(np.int32)
