"""Wire protocol for the tuning fleet: framing + version negotiation.

Every message — worker RPC and tuning-service RPC alike — is a
**length-prefixed JSON object**: a 4-byte big-endian unsigned length
followed by that many bytes of UTF-8 JSON.  ``NaN`` and ``±Infinity``
use the Python ``json`` literals (both ends are this codebase), so
``-inf`` failure scores survive the round trip.

Version negotiation (v2)
------------------------

Version 1 had no negotiation: the client sent ``{"type": "hello",
"protocol": 1}`` and the worker rejected anything whose ``protocol``
was not exactly 1.  Version 2 keeps that hello *unchanged* and adds a
``max_protocol`` key next to it::

    {"type": "hello", "protocol": 1, "max_protocol": 2}

* a **v1 server** checks ``protocol == 1`` (true) and ignores keys it
  does not know — so a v2 client registers against a v1 worker and the
  session simply runs the v1 message set;
* a **v2 server** answers with the highest version both sides support
  (``min(client max_protocol, server ceiling)``) in its register/
  welcome reply, and the session speaks that version from then on.

``protocol`` in the hello therefore stays pinned at 1 forever — it is
the *floor* (and the compatibility statement), ``max_protocol`` is the
ceiling.  :func:`negotiate` implements the server side; clients read
the chosen version out of the reply's ``protocol`` field.

Version 2 message set (on top of v1's task/result/heartbeat/bye):

===================  ====================================================
``submit_job``       client -> service: a :class:`JobSpec` payload
``job_accepted``     service -> client: ``{"job_id": ...}``
``job_status``       client -> service: ``{"job_id": ...}``
``status``           service -> client: progress snapshot (state, evals,
                     best, best-so-far curve, rung stats, fleet health)
``list_jobs``        client -> service
``jobs``             service -> client: one summary row per job
``cancel_job``       client -> service: ``{"job_id": ...}``
``leaving``          worker -> tuner: clean deregistration — the pool
                     stops dispatching here, drains this worker's
                     in-flight results, then ends the session with
                     ``bye`` (elastic fleets)
``error``            either direction: ``{"error": "..."}``
===================  ====================================================

A v2 ``task`` message may additionally carry a ``state`` field: the
opaque checkpoint-fork blob (a prior step's ``meta["fork_state"]``,
PBT lineages) the worker forwards to its objective as
``resume_state``.  The pool only routes stateful tasks to v2 workers;
a v1 worker never sees the field.

A v2 worker's ``register`` reply additionally carries a
``fingerprint`` object (``tundb.hardware_fingerprint()`` form) so the
pool can partition a mixed fleet by hardware; v1 workers simply omit
it and land in the synthetic "unknown" partition.  Both sides ignore
unknown keys, so every addition above is invisible to a v1 peer.

This module is deliberately stdlib-only (no torch, no numpy): worker
daemons and thin clients import it on hosts that have nothing else
installed.
"""
from __future__ import annotations

import json
import socket
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

#: the original worker-RPC protocol: hello/register/task/result/
#: heartbeat/bye, no negotiation.
PROTOCOL_V1 = 1
#: adds version negotiation (``max_protocol``), register-time error
#: reporting, and the tuning-service job message set.
PROTOCOL_V2 = 2
SUPPORTED_PROTOCOLS = (PROTOCOL_V1, PROTOCOL_V2)

_HEADER = struct.Struct(">I")
# corruption guard, not a capacity plan: a frame is one point/result
MAX_FRAME_BYTES = 64 << 20
DEFAULT_HEARTBEAT_S = 2.0


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def send_msg(sock: socket.socket, obj: dict) -> None:
    """Send one length-prefixed JSON message."""
    data = json.dumps(obj, allow_nan=True).encode("utf-8")
    sock.sendall(_HEADER.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the connection mid-frame")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> dict:
    """Receive one length-prefixed JSON message (blocking)."""
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame of {length} bytes exceeds the {MAX_FRAME_BYTES}-byte "
            "protocol limit (corrupt stream?)")
    msg = json.loads(_recv_exact(sock, length).decode("utf-8"))
    if not isinstance(msg, dict):
        raise ValueError(f"protocol messages are JSON objects, got {type(msg)}")
    return msg


def parse_address(addr: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)`` with a helpful error."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"worker address {addr!r} is not host:port")
    return host, int(port)


# ---------------------------------------------------------------------------
# version negotiation
# ---------------------------------------------------------------------------

def hello(max_protocol: int = PROTOCOL_V2) -> dict:
    """The client-side hello.  ``protocol`` is pinned to 1 — the floor a
    v1 server insists on — and ``max_protocol`` advertises the ceiling."""
    msg = {"type": "hello", "protocol": PROTOCOL_V1}
    if max_protocol > PROTOCOL_V1:
        msg["max_protocol"] = int(max_protocol)
    return msg


def negotiate(hello_msg: dict, ceiling: int = PROTOCOL_V2) -> Optional[int]:
    """Server side: the version this session will speak, or ``None`` if
    the hello is not compatible.

    ``ceiling`` caps what the server offers (tests pin it to 1 to
    exercise the v1-server path).
    """
    if hello_msg.get("type") != "hello":
        return None
    base = hello_msg.get("protocol")
    if base != PROTOCOL_V1:  # the floor never moves: v1 compat statement
        return None
    peer_max = hello_msg.get("max_protocol", base)
    try:
        chosen = min(int(peer_max), int(ceiling))
    except (TypeError, ValueError):
        return None
    chosen = max(chosen, PROTOCOL_V1)
    return chosen if chosen in SUPPORTED_PROTOCOLS else PROTOCOL_V1


# ---------------------------------------------------------------------------
# job specification (service wire/checkpoint schema)
# ---------------------------------------------------------------------------

@dataclass
class JobSpec:
    """What a client submits: a search space + tuner configuration.

    ``space`` is ``SearchSpace.to_dicts()`` form; ``config`` is
    ``TunerConfig.to_dict()`` form (validated server-side by
    ``TunerConfig.from_dict``, so unknown keys come back as a precise
    ``error`` reply, not a silent ignore).  ``objective`` optionally
    names a ``module:factory()`` spec for services running local
    measurement — services driving a remote fleet ignore it (workers
    own their objectives).
    """
    space: List[dict]
    config: dict = field(default_factory=dict)
    name: str = ""
    objective: Optional[str] = None

    def to_dict(self) -> dict:
        return {"space": [dict(d) for d in self.space],
                "config": dict(self.config), "name": self.name,
                "objective": self.objective}

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        unknown = set(d) - {"space", "config", "name", "objective"}
        if unknown:
            raise ValueError(
                f"unknown JobSpec key(s): {sorted(unknown)} "
                "(known: space, config, name, objective)")
        space = d.get("space")
        if not isinstance(space, list) or not space:
            raise ValueError("JobSpec needs a non-empty 'space' list "
                             "(SearchSpace.to_dicts() form)")
        return cls(space=[dict(x) for x in space],
                   config=dict(d.get("config") or {}),
                   name=str(d.get("name") or ""),
                   objective=d.get("objective"))
