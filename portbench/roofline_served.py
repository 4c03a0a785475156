"""The yardstick's arithmetic for K5 in the served prefill: the RWKV-6 scan
that also writes the state after the last token (``gla_scan_state``, the
kernel ``gla_state_kernel``).  Beside ``roofline.py``, whose functions it
uses and does not change.

Its decay is float32 whatever the operands' type, and its arithmetic is
float32 on the SIMT cores in every case, so its least time takes the
operations at the f32 rate (``roofline.least_seconds(..., "f32")``), not
at the bf16 tensor-core rate.
"""
from __future__ import annotations

from portbench.roofline import ITEMSIZE, least_seconds, rows


def k5_state_call(B: int, S, H: int, dk: int, dv: int, dtype: str):
    """One state-writing K5 call over ``B`` sequences of ``S`` tokens (one
    length, or one a row: the prompts' own lengths, so that the padding a
    wave is packed with counts as no work).  Operations as
    ``roofline.k5_call`` counts them; bytes: r, k, v read and y written in
    ``dtype``, w read in float32, u read once, the final state (B, H, dk,
    dv) written in float32."""
    tokens = sum(rows(B, S))
    flops = tokens * H * (5 * dk * dv + 3 * dk + 2 * dv)
    nbytes = (ITEMSIZE[dtype] * tokens * H * (2 * dk + 2 * dv)  # r, k; v, y
              + 4 * tokens * H * dk  # w
              + 4 * H * dk  # u
              + 4 * B * H * dk * dv)  # the final state
    return flops, nbytes


def k5_state_seconds(port: dict, dtype: str, B: int, S) -> float:
    """The least time of one layer's state-writing K5 call in a prefill of
    ``B`` prompts of ``S`` tokens."""
    hs = port["rwkv"]["head_size"]
    return least_seconds(*k5_state_call(B, S, port["d_model"] // hs, hs, hs, dtype), "f32")
