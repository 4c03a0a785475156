"""The one traffic generator: it reads a cell's ``traffic`` parameters (a
block of its JSON file) and the seed, and yields what the drivers feed the
program.  Three kinds, by the parameters present:

* ``sessions``: cached contexts of ``context`` tokens, ``sessions`` of them,
  asked again turn after turn: each turn gives every session a fresh first
  token and decodes ``gen`` tokens.  ``turn(j)`` is turn ``j``'s first
  tokens.
* ``batch`` with ``prompt_min``: waves of ``batch`` requests, prompt
  lengths log-uniform on ``prompt_min .. prompt_max``, left-padded to
  ``pad_to`` (as the program's ``launch/serve.py`` packs them), ``gen``
  tokens each.  ``wave(j)`` is wave ``j``.
* ``seq``: training batches of ``batch`` rows of ``seq`` tokens from the
  noisy affine bigram stream below; every row of every step differs.

Every seed gets the same sizes (prompts are padded to one length), so the
seed changes the tokens and not the work.  Token ids are drawn from
``1 .. vocab - 1``: 0 is the padding.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import seeds


@dataclass
class Wave:
    tokens: np.ndarray  # (batch, pad_to) int32, left-padded with 0
    lengths: np.ndarray  # (batch,) the prompts' own lengths


class Traffic:
    def __init__(self, params: dict, vocab: int, seed: int):
        self.p, self.vocab, self.seed = dict(params), vocab, seed

    # -- sessions over cached contexts ------------------------------------
    def turn(self, j: int) -> np.ndarray:
        r = seeds.rng(self.seed, "turn", j)
        return r.integers(1, self.vocab, size=self.p["sessions"]).astype(np.int32)

    # -- waves of requests ------------------------------------------------
    def wave(self, j: int) -> Wave:
        p = self.p
        r = seeds.rng(self.seed, "wave", j)
        lo, hi = np.log(p["prompt_min"]), np.log(p["prompt_max"])
        lengths = np.minimum(np.exp(r.uniform(lo, hi, size=p["batch"])).astype(np.int64),
                             p["prompt_max"])
        toks = np.zeros((p["batch"], p["pad_to"]), np.int32)
        for i, n in enumerate(lengths):
            toks[i, p["pad_to"] - n:] = r.integers(1, self.vocab, size=n)
        return Wave(toks, lengths)

    # -- training batches -------------------------------------------------
    def batch(self, step: int) -> dict:
        return bigram_batch(seeds.derive(self.seed, "data"), step, self.p["batch"],
                            self.p["seq"], self.vocab)


def _mix(a: np.ndarray) -> np.ndarray:
    """splitmix64-style integer hash (vectorized, deterministic)."""
    a = (a + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    a ^= a >> np.uint64(30)
    a = (a * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    a ^= a >> np.uint64(27)
    a = (a * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return a ^ (a >> np.uint64(31))


def bigram_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                 noise: float = 0.1) -> dict:
    """``tokens`` and ``targets`` (batch, seq) int32 of a noisy affine bigram
    stream, ``x_{t+1} = 3 x_t + 7 (mod vocab)`` with a ``noise`` share of
    random tokens: a copy of the program's ``data/pipeline.py``
    (``SyntheticTokens.batch_at``), kept here so that the yardstick does not
    move with the program.  Rows are hashed from ``(seed, step, row)``."""
    rows = np.arange(batch).astype(np.uint64)
    toks = np.empty((batch, seq + 1), np.int64)
    with np.errstate(over="ignore"):
        base = _mix(rows[:, None] * np.uint64(1_000_003)
                    + np.uint64(step) * np.uint64(7_919)
                    + np.uint64(seed % (1 << 63)) * np.uint64(104_729))
        toks[:, 0] = base[:, 0] % vocab
        h = base[:, 0]
        for t in range(1, seq + 1):
            h = _mix(h + np.uint64(t))
            rand_tok = (h % np.uint64(vocab)).astype(np.int64)
            is_noise = (h >> np.uint64(40)).astype(np.float64) / float(2 ** 24) < noise
            toks[:, t] = np.where(is_noise, rand_tok, (toks[:, t - 1] * 3 + 7) % vocab)
    return {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
