"""Plain float32 reference of the dense GQA decoder the ``qwen2-0.5b`` cells
run (the program's ``models/lm.py`` with attention mixers): pre-norm
RMSNorm blocks, rotary embedding, grouped-query attention with QKV bias,
a SwiGLU MLP, the head tied to the embedding.

It computes the logits at chosen positions of whole sequences, optionally
after a cached context whose keys (stored after their rotation) and values
the caller hands in layer by layer: the benchmark made them, so the
reference reads them as made and not from the program's cache.  It runs
layer by layer and attends in blocks of queries, so that a 32k context or
an 8k prompt fits beside the weights.  Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import Products, rmsnorm, rope

BLOCK_Q = 1024


def _attend(q, k, v, first: int, scale: float, group: int) -> torch.Tensor:
    """Causal attention of ``q`` (N, S, H, dh), at absolute positions
    ``first ..``, over ``k``/``v`` (N, first + S, K, dh), float32."""
    N, S, H, dh = q.shape
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    out = torch.empty_like(q)
    kpos = torch.arange(k.shape[1], device=q.device)
    for lo in range(0, S, BLOCK_Q):
        hi = min(S, lo + BLOCK_Q)
        reach = first + hi  # keys a later query of the block may read
        s = torch.einsum("nqhd,nkhd->nhqk", q[:, lo:hi], k[:, :reach]) * scale
        qpos = first + torch.arange(lo, hi, device=q.device)
        s = s.masked_fill(kpos[None, None, None, :reach] > qpos[None, None, :, None],
                          float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, lo:hi] = torch.einsum("nhqk,nkhd->nqhd", p, v[:, :reach])
    return out


def logits(w: dict, port: dict, tokens: torch.Tensor, *, first: int = 0,
           context: Optional[Callable[[int], tuple]] = None,
           at: Optional[torch.Tensor] = None,
           products: Optional[Products] = None,
           keep: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None
           ) -> torch.Tensor:
    """Logits (N, len(at), vocab) in float32 of ``tokens`` (N, S) at absolute
    positions ``first .. first + S - 1``, at the sequence indices ``at``
    (all where None).  ``context(layer)`` gives that layer's cached keys and
    values (N, first, K, dh) of positions ``0 .. first - 1``; None where
    ``first`` is 0.  ``keep(layer, k, v)``, where given, is handed each
    layer's keys (after their rotation) and values of ``tokens`` (N, S, K,
    dh) as the reference stores them."""
    pr = products or Products()
    N, S = tokens.shape
    D, H, K = port["d_model"], port["num_heads"], port["num_kv_heads"]
    dh = port.get("head_dim") or D // H
    eps, theta = port.get("norm_eps", 1e-5), port.get("rope_theta", 10000.0)
    blk = w["blocks"]["pos0"]
    pos = torch.arange(first, first + S, device=tokens.device)
    x = w["embed"][tokens.long()].float()
    for l in range(port["num_layers"]):
        a = blk["mixer"]
        h = rmsnorm(x, blk["norm1"]["scale"][l], eps)

        def proj(name, heads):
            y = pr.mm(h, a[name][l].reshape(D, heads * dh)).reshape(N, S, heads, dh)
            bias = a.get("b" + name[1:])
            return y if bias is None else y + bias[l].float()

        q = rope(proj("wq", H), pos, theta)
        k = rope(proj("wk", K), pos, theta)
        v = proj("wv", K)
        if keep is not None:
            keep(l, pr.cache(k), pr.cache(v))
        if first:
            ck, cv = context(l)
            k = torch.cat([pr.cache(ck), k], dim=1)
            v = torch.cat([pr.cache(cv), v], dim=1)
        o = _attend(q, k, v, first, 1.0 / math.sqrt(dh), H // K)
        x = x + pr.mm(o.reshape(N, S, H * dh), a["wo"][l].reshape(H * dh, D))
        m = blk["mlp"]
        h = rmsnorm(x, blk["norm2"]["scale"][l], eps)
        g = F.silu(pr.mm(h, m["w_gate"][l])) * pr.mm(h, m["w_up"][l])
        x = x + pr.mm(g, m["w_down"][l])
    if at is not None:
        x = x[:, at]
    x = rmsnorm(x, w["final_norm"]["scale"], eps)
    head = w["head"] if "head" in w else w["embed"].T
    return pr.mm(x, head)
