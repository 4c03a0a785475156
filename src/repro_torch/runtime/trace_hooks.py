"""Hooks through which a step shows its structure to a trace
(``repro_torch.tuning.trace_analysis``, the dry run's op-level analysis).

* ``region(tag, fn, *args)`` runs ``fn(*args)`` as the kernel region
  ``tag``: the reference's ``named_scope("krnl_...")`` around the oracle
  forms of its kernels.  A trace leaves such a region's ops out of the
  per-op traffic and credits the kernel's stream traffic instead.
* ``repeat(fn, *args)`` runs ``fn(*args)``, a call that its step repeats
  on inputs of the same shapes (the microbatch loop of a train step): a
  trace may account a repeat from the record of the first call instead of
  running it again.

Without a trace in the calling thread each hook is one thread-local read
and the plain call, so the hooks cost nothing on the kernel path.
"""
from __future__ import annotations

import threading

_TLS = threading.local()


def set_active(tracer):
    """Make ``tracer`` this thread's trace; returns the previous one."""
    prev = getattr(_TLS, "tracer", None)
    _TLS.tracer = tracer
    return prev


def region(tag: str, fn, *args):
    tracer = getattr(_TLS, "tracer", None)
    if tracer is None:
        return fn(*args)
    return tracer.region(tag, fn, args)


def repeat(fn, *args):
    tracer = getattr(_TLS, "tracer", None)
    if tracer is None:
        return fn(*args)
    return tracer.repeat(fn, args)
