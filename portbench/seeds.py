"""Seeds of the parts of a run, all from ``--seed``: the weights, the
traffic, the cached contexts and the correctness sample each draw from a
stream of their own, so that one part's size never shifts another's
numbers.  ``--seed`` may be any whole number, also one larger than 32 bits
hold."""
from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``(seed, *tags)``."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))
