"""Parameter search space (paper §2.2, Table 1).

Dimensions are integer ranges with (min, max, step) — exactly the paper's
tunable-range formulation — or categoricals.  Points are dicts
``{name: value}``.  The space encodes points into the unit hypercube for
the GP surrogate and decodes/snaps arbitrary unit-cube vectors back onto
the grid.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class IntDim:
    name: str
    lo: int
    hi: int
    step: int = 1

    @property
    def values(self) -> Tuple[int, ...]:
        return tuple(range(self.lo, self.hi + 1, self.step))


@dataclass(frozen=True)
class CatDim:
    name: str
    choices: Tuple

    @property
    def values(self) -> Tuple:
        return tuple(self.choices)


Dim = Union[IntDim, CatDim]


class SearchSpace:
    def __init__(self, dims: Sequence[Dim]):
        assert dims, "empty search space"
        self.dims: List[Dim] = list(dims)
        names = [d.name for d in self.dims]
        assert len(set(names)) == len(names), f"duplicate dims: {names}"

    @classmethod
    def from_dicts(cls, dicts: Sequence[dict]) -> "SearchSpace":
        dims: List[Dim] = []
        for d in dicts:
            if d["type"] == "int":
                dims.append(IntDim(d["name"], d["min"], d["max"], d.get("step", 1)))
            elif d["type"] == "cat":
                dims.append(CatDim(d["name"], tuple(d["choices"])))
            else:
                raise ValueError(d)
        return cls(dims)

    def to_dicts(self) -> List[dict]:
        """Inverse of :meth:`from_dicts` — the wire/checkpoint form the
        tuning service serializes job search spaces as."""
        out: List[dict] = []
        for d in self.dims:
            if isinstance(d, IntDim):
                out.append({"type": "int", "name": d.name, "min": d.lo,
                            "max": d.hi, "step": d.step})
            else:
                out.append({"type": "cat", "name": d.name,
                            "choices": list(d.choices)})
        return out

    # -- basics --------------------------------------------------------------
    @property
    def n_dims(self) -> int:
        return len(self.dims)

    @property
    def names(self) -> List[str]:
        return [d.name for d in self.dims]

    def grid_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= len(d.values)
        return n

    def enumerate(self) -> Iterator[Dict]:
        value_lists = [d.values for d in self.dims]
        for combo in itertools.product(*value_lists):
            yield dict(zip(self.names, combo))

    def key(self, point: Dict) -> Tuple:
        """Hashable identity of a point (memoization key)."""
        return tuple(point[d.name] for d in self.dims)

    def validate(self, point: Dict) -> bool:
        for d in self.dims:
            if point.get(d.name) not in d.values:
                return False
        return True

    # -- encoding ------------------------------------------------------------
    def encode(self, point: Dict) -> np.ndarray:
        """point -> unit hypercube [0, 1]^d."""
        u = np.zeros(self.n_dims)
        for i, d in enumerate(self.dims):
            vals = d.values
            idx = vals.index(point[d.name])
            u[i] = idx / max(len(vals) - 1, 1)
        return u

    def decode(self, u: np.ndarray) -> Dict:
        """unit-cube vector -> nearest grid point."""
        point = {}
        for i, d in enumerate(self.dims):
            vals = d.values
            idx = int(round(np.clip(u[i], 0.0, 1.0) * (len(vals) - 1)))
            point[d.name] = vals[idx]
        return point

    def encode_many(self, points: Sequence[Dict]) -> np.ndarray:
        return np.stack([self.encode(p) for p in points]) if points else np.zeros((0, self.n_dims))

    # -- sampling ------------------------------------------------------------
    def sample(self, rng: np.random.Generator, n: int = 1) -> List[Dict]:
        out = []
        for _ in range(n):
            out.append({d.name: d.values[rng.integers(len(d.values))] for d in self.dims})
        return out

    def sample_lhs(self, rng: np.random.Generator, n: int) -> List[Dict]:
        """Latin-hypercube-ish init: stratified per dimension."""
        cols = []
        for d in self.dims:
            strata = (np.arange(n) + rng.random(n)) / n
            rng.shuffle(strata)
            cols.append(strata)
        U = np.stack(cols, axis=1)
        return [self.decode(U[i]) for i in range(n)]

    def perturb(self, rng: np.random.Generator, point: Dict, radius: int = 1) -> Dict:
        """Neighbor: move a random subset of dims by +-radius grid steps."""
        new = dict(point)
        k = max(1, rng.integers(1, self.n_dims + 1) // 2)
        for i in rng.choice(self.n_dims, size=k, replace=False):
            d = self.dims[i]
            vals = d.values
            idx = vals.index(new[d.name])
            idx = int(np.clip(idx + rng.integers(-radius, radius + 1), 0, len(vals) - 1))
            new[d.name] = vals[idx]
        return new
