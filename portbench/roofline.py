"""The yardstick's arithmetic: the operations and bytes one kernel call or
one model step needs, as functions of the shapes, whatever implements it,
and the NVIDIA H100 SXM's published peaks (data sheet, dense rates, 700 W).

A roofline share is the least time the card could take, the larger of
operations over the peak rate and bytes over the memory bandwidth, over
the time measured.  Each input byte is counted read once and each output
byte written once; operations are those the algorithm needs for these
inputs (a causal mask halves the pairs; a recompute is not counted).
Elementwise work outside the kernels (norms, activations, rotary
embedding, softmax) is left out of a step's operations, so a step's share
is a lower bound of what it achieves.

A length (``S`` of a prefill, ``length`` of a decode) is one number for
every sequence of the batch, or a sequence of ``B`` numbers, one a row:
the rows' own lengths, so that the padding a batch is packed with counts
as no work that a request needs.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, dense: FLOP/s by the type the products run in, bytes/s of HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bf16": 2, "f32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def rows(B: int, n) -> list:
    """The ``B`` rows' lengths: ``n`` for each, or ``n`` itself."""
    if isinstance(n, int):
        return [n] * B
    n = [int(x) for x in n]
    if len(n) != B:
        raise ValueError(f"{len(n)} lengths for a batch of {B}")
    return n


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def k2_call(B: int, S: int, H: int, K: int, dh: int, dtype: str):
    """Causal flash attention (K2) forward over ``S`` queries and keys: QK
    and PV, 2 * dh operations a pair each, over the pairs the mask keeps."""
    lengths = rows(B, S)
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    flops = 4 * H * dh * pairs
    nbytes = ITEMSIZE[dtype] * sum(lengths) * dh * (2 * H + 2 * K)  # q, o; k, v
    return flops, nbytes


def k3_call(B: int, H: int, K: int, dh: int, length: int, dtype: str):
    """Decode attention (K3): one query a sequence against ``length`` cached
    keys and values, which the program stores in bf16 whatever ``dtype``."""
    keys = sum(rows(B, length))
    flops = 4 * H * dh * keys
    nbytes = (ITEMSIZE["bf16"] * 2 * keys * K * dh
              + ITEMSIZE[dtype] * 2 * B * H * dh + 4 * B)
    return flops, nbytes


def k5_call(B: int, S: int, H: int, dk: int, dv: int, dtype: str):
    """The RWKV-6 scan (K5) forward: per token and head, ``r . S`` (2 dk dv),
    the state's decay and update (3 dk dv), the current-token bonus
    (3 dk + 2 dv); r, k, w and v read, y written, u read."""
    tokens = sum(rows(B, S))
    flops = tokens * H * (5 * dk * dv + 3 * dk + 2 * dv)
    nbytes = ITEMSIZE[dtype] * (tokens * H * (3 * dk + 2 * dv) + H * dk)
    return flops, nbytes


# ---------------------------------------------------------------------------
# Model steps
# ---------------------------------------------------------------------------


def _dims(port: dict):
    D, L = port["d_model"], port["num_layers"]
    m = port.get("vocab_pad_multiple", 256)
    V = -(-port["vocab_size"] // m) * m
    return D, L, V


def layer_matmul_params(port: dict) -> int:
    """Weights of one layer that enter a matrix product (each used once a
    token)."""
    D, F = port["d_model"], port["d_ff"]
    if port.get("rwkv"):
        rc = port["rwkv"]
        ml, dl = rc["mix_lora"], rc["decay_lora"]
        return 2 * 5 * ml * D + 2 * dl * D + 5 * D * D + 2 * D * F + D * D
    H, K = port["num_heads"], port["num_kv_heads"]
    dh = port.get("head_dim") or D // H
    return D * (H + 2 * K) * dh + H * dh * D + 3 * D * F


def weight_bytes(port: dict, dtype: str) -> int:
    """Bytes of every weight a step reads once: each layer's, the head (the
    tied embedding where there is no head) and the norms."""
    D, L, V = _dims(port)
    return ITEMSIZE[dtype] * (L * (layer_matmul_params(port) + 2 * D) + D * V + D)


def _attn(port):
    D = port["d_model"]
    H, K = port["num_heads"], port["num_kv_heads"]
    return H, K, port.get("head_dim") or D // H


def decode_step(port: dict, dtype: str, B: int, length: int):
    """One decode token for ``B`` sequences, each attending ``length``
    positions (a recurrent state for RWKV)."""
    D, L, V = _dims(port)
    flops = 2 * B * (L * layer_matmul_params(port) + D * V)
    nbytes = weight_bytes(port, dtype) + ITEMSIZE[dtype] * B * V  # the logits
    if port.get("rwkv"):
        hs = port["rwkv"]["head_size"]
        H = D // hs
        flops += L * B * H * (5 * hs * hs + 5 * hs)
        nbytes += L * B * 4 * (2 * H * hs * hs + 4 * D)  # f32 state and shifts, read and written
    else:
        H, K, dh = _attn(port)
        f, b = k3_call(B, H, K, dh, length, dtype)
        flops += L * f
        nbytes += L * (b + 2 * 2 * B * K * dh)  # + the new key and value written
    return flops, nbytes


def prefill_step(port: dict, dtype: str, B: int, S: int):
    """The prefill of ``B`` prompts of ``S`` tokens: every layer over every
    token, the head at the last position only, the cache written."""
    D, L, V = _dims(port)
    tokens = sum(rows(B, S))
    flops = 2 * (tokens * L * layer_matmul_params(port) + B * D * V)
    nbytes = weight_bytes(port, dtype) + ITEMSIZE[dtype] * B * V
    if port.get("rwkv"):
        hs = port["rwkv"]["head_size"]
        f, b = k5_call(B, S, D // hs, hs, hs, dtype)
        flops += L * f
        nbytes += L * (b + B * 4 * ((D // hs) * hs * hs + 2 * D))
    else:
        H, K, dh = _attn(port)
        f, b = k2_call(B, S, H, K, dh, dtype)
        flops += L * f
        nbytes += L * (b + 2 * 2 * tokens * K * dh)
    return flops, nbytes


def train_step(port: dict, dtype: str, B: int, S: int):
    """A training step: forward and backward (3 times the forward's
    products, no recompute counted) and the AdamW update (parameters,
    gradients and both moments read, three of them written)."""
    D, L, V = _dims(port)
    n = L * layer_matmul_params(port) + D * V
    flops = 6 * B * S * n
    if port.get("rwkv"):
        hs = port["rwkv"]["head_size"]
        flops += 3 * L * k5_call(B, S, D // hs, hs, hs, dtype)[0]
    else:
        H, K, dh = _attn(port)
        flops += 3 * L * k2_call(B, S, H, K, dh, dtype)[0]
    nbytes = weight_bytes(port, dtype) * (2 + 7)  # forward and backward reads; the update
    return flops, nbytes
