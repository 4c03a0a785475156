"""The `Observation` record: one completed measurement, everywhere.

Before this module, a completed measurement travelled as parallel
positional sequences — ``Engine.tell(points, values, costs=...,
fidelities=...)``, mirrored by ``History.add_batch`` and the executor's
completion plumbing — which meant every new per-measurement field
(fidelity, rung, meta) widened *four* signatures and silently defaulted
everywhere it was forgotten.  :class:`Observation` collapses the sprawl
into a single dataclass that is also the canonical **wire format**: the
tuning service's ``submit_job``/``job_status`` messages and the job
checkpoint snapshots serialize observations with :meth:`to_dict` /
:meth:`from_dict`, so what an engine is told, what a history records,
and what crosses a socket are one schema.

This module is dependency-light on purpose (stdlib only): the remote
protocol layer imports it without pulling in numpy or torch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Observation:
    """One completed evaluation reported back to an engine / history.

    ``point``         the measured configuration (dict of parameter values)
    ``value``         objective (throughput-like; higher is better;
                      ``-inf`` marks a failed configuration)
    ``cost_seconds``  measured cost of producing the value (0.0 = unknown
                      or free, e.g. a memoized repeat)
    ``fidelity``      fraction of a full measurement the value came from
                      (1.0 = exact/full; < 1.0 = cheaper, noisier)
    ``rung``          scheduler coordinate the measurement ran at — the
                      successive-halving rung for ASHA, the *global*
                      (bracket-offset) rung for HyperBand, the step
                      index for PBT (``None`` = outside any scheduler)
    ``lineage``       trial-ancestry tag for scheduler provenance —
                      HyperBand's bracket (``b<idx>``), PBT's member
                      lineage (``m<k>``); ``None`` = no lineage.  The
                      resume path routes ``replay`` by it, and PBT's
                      checkpoint-fork steps are memo-keyed by it
    ``meta``          JSON-serializable annotations from the evaluator
    """

    point: Dict
    value: float
    cost_seconds: float = 0.0
    fidelity: float = 1.0
    rung: Optional[int] = None
    lineage: Optional[str] = None
    meta: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        """Wire/checkpoint form (plain JSON-serializable dict)."""
        return {
            "point": dict(self.point), "value": self.value,
            "cost_seconds": self.cost_seconds, "fidelity": self.fidelity,
            "rung": self.rung, "lineage": self.lineage,
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Observation":
        return cls(
            point=dict(d["point"]), value=float(d["value"]),
            cost_seconds=float(d.get("cost_seconds", 0.0)),
            fidelity=float(d.get("fidelity", 1.0)),
            rung=d.get("rung"),
            lineage=d.get("lineage"),
            meta=dict(d.get("meta") or {}),
        )
