"""The one traffic generator: a mix file's parameters and the seed in, the
batches a cell runs out. The same seed gives the same inputs, and every
seed the same sizes: only the tokens change with it.

Tokens follow a Zipf law over the vocabulary past its ``reserved`` ids
(rank r with weight r ** -exponent), the arithmetic of the program's
synthetic LM stream.
"""

from __future__ import annotations

import numpy as np


class Zipf:
    def __init__(self, vocab: int, exponent: float, reserved: int):
        ranks = np.arange(1, vocab - reserved + 1, dtype=np.float64)
        p = ranks**-exponent
        self.cdf = np.cumsum(p / p.sum())
        self.reserved = reserved

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        i = np.searchsorted(self.cdf, rng.random(n) * self.cdf[-1], side="right")
        return (np.minimum(i, len(self.cdf) - 1) + self.reserved).astype(np.int32)


def zipf_of(mix: dict, vocab: int) -> Zipf:
    t = mix["tokens"]
    return Zipf(vocab, t["exponent"], t["reserved"])


def train_batches(mix: dict, vocab: int, seed: int, n: int) -> list[dict]:
    """``n`` batches of ``tokens`` (B, S) int32 (targets are the tokens:
    the loss shifts them), every row different."""
    b, s = mix["batch"], mix["seq"]
    toks = zipf_of(mix, vocab).draw(np.random.default_rng(seed), n * b * s).reshape(n, b, s)
    return [{"tokens": t, "targets": t} for t in toks]
