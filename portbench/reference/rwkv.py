"""Plain float32 reference of the RWKV-6 decoder the ``rwkv6-3b`` cells run
(the program's ``models/lm.py`` with RWKV mixers): pre-norm RMSNorm blocks;
the time mix with its data-dependent token-shift (ddlerp) and decay, the
WKV recurrence with its current-token bonus and a LayerNorm over the heads'
output (``ln_x``); the squared-ReLU channel mix; an untied head.

The recurrence, per head, for tokens ``t``:

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

is computed exactly in chunks of ``CHUNK`` tokens: inside a chunk every
pair ``s < t`` is weighted by ``exp(sum of log w over s+1 .. t-1)``, which
is at most 1, so nothing overflows; the state is carried from chunk to
chunk.  Differentiable, for the training cell's gradients.  Imports
nothing of the program.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import Products, layernorm, rmsnorm

CHUNK = 16


def wkv(r, k, v, w, u) -> torch.Tensor:
    """``y`` (N, S, H, dv) of the recurrence from a zero state; r, k, w
    (N, S, H, dk), v (N, S, H, dv), u (H, dk); float32."""
    N, S, H, dk = r.shape
    C = CHUNK
    pad = (-S) % C
    if pad:  # padded tokens: no key, no query, no decay
        z = lambda a, fill=0.0: F.pad(a, (0, 0, 0, 0, 0, pad), value=fill)
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    n = r.shape[1] // C
    # (N, H, n, C, d)
    r, k, v, w = (a.reshape(N, n, C, H, a.shape[-1]).permute(0, 3, 1, 2, 4) for a in (r, k, v, w))
    lw = torch.log(w)
    inc = torch.cumsum(lw, dim=3)  # log decay through token t of its chunk
    exc = inc - lw  # ... through t - 1
    # intra-chunk pairs s < t: sum_j r_t[j] k_s[j] exp(exc_t[j] - inc_s[j])
    diff = exc[:, :, :, :, None, :] - inc[:, :, :, None, :, :]  # (N,H,n,t,s,dk)
    tri = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    decay = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    att = torch.einsum("zhntd,zhnsd,zhntsd->zhnts", r, k, decay)
    y = torch.einsum("zhnts,zhnsv->zhntv", att, v)
    y = y + torch.einsum("zhntd,hd,zhntd->zhnt", r, u, k)[..., None] * v
    # carried state: S enters chunk c decayed by exc_t for query t
    rq = r * torch.exp(exc)
    kin = k * torch.exp(inc[:, :, :, -1:, :] - inc)  # k_s decayed to the chunk's end
    state = r.new_zeros(N, H, dk, v.shape[-1])
    carried = []
    for c in range(n):
        carried.append(torch.einsum("zhtd,zhdv->zhtv", rq[:, :, c], state))
        state = (torch.exp(inc[:, :, c, -1])[..., None] * state
                 + torch.einsum("zhsd,zhsv->zhdv", kin[:, :, c], v[:, :, c]))
    y = y + torch.stack(carried, dim=2)
    y = y.permute(0, 2, 3, 1, 4).reshape(N, n * C, H, -1)
    return y[:, :S]


def _shift(x):
    """The previous token of every position (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def hidden(w: dict, port: dict, tokens: torch.Tensor,
           products: Optional[Products] = None) -> torch.Tensor:
    """The final hidden states (N, S, D), float32, before the final norm."""
    pr = products or Products()
    N, S = tokens.shape
    D = port["d_model"]
    rc = port["rwkv"]
    hs, ml = rc["head_size"], rc["mix_lora"]
    H = D // hs
    eps = port.get("norm_eps", 1e-5)
    blk = w["blocks"]["pos0"]
    a, c = blk["mixer"], blk["mlp"]
    x = w["embed"][tokens.long()].float()
    for l in range(port["num_layers"]):
        h = rmsnorm(x, blk["norm1"]["scale"][l], eps)
        dx = _shift(h) - h
        lora = torch.tanh(pr.mm(h, a["mix_w1"][l])).reshape(N, S, 5, ml)
        mu = a["mu"][l].float()
        xw, xk, xv, xr, xg = (h + dx * (mu[i] + pr.mm(lora[:, :, i], a["mix_w2"][l, i]))
                              for i in range(5))
        r = pr.mm(xr, a["wr"][l]).reshape(N, S, H, hs)
        k = pr.mm(xk, a["wk"][l]).reshape(N, S, H, hs)
        v = pr.mm(xv, a["wv"][l]).reshape(N, S, H, hs)
        g = F.silu(pr.mm(xg, a["wg"][l]))
        wr = pr.mm(torch.tanh(pr.mm(xw, a["w_lora1"][l])), a["w_lora2"][l]) + a["w_bias"][l].float()
        decay = torch.exp(-torch.exp(wr)).reshape(N, S, H, hs)
        y = wkv(r, k, v, decay, a["u"][l].float()).reshape(N, S, D)
        y = layernorm(y, a["ln_x"]["scale"][l], a["ln_x"]["bias"][l], 1e-5)
        x = x + pr.mm(y * g, a["wo"][l])
        h = rmsnorm(x, blk["norm2"]["scale"][l], eps)
        dx = _shift(h) - h
        kk = torch.relu(pr.mm(h + dx * c["mu_k"][l].float(), c["wk"][l])).square()
        rr = torch.sigmoid(pr.mm(h + dx * c["mu_r"][l].float(), c["wr"][l]))
        x = x + rr * pr.mm(kk, c["wv"][l])
    return x


def logits(w: dict, port: dict, tokens: torch.Tensor, *, at: Optional[torch.Tensor] = None,
           products: Optional[Products] = None) -> torch.Tensor:
    """Logits (N, len(at), vocab) in float32 at the sequence indices ``at``
    (all where None)."""
    pr = products or Products()
    x = hidden(w, port, tokens, pr)
    if at is not None:
        x = x[:, at]
    x = rmsnorm(x, w["final_norm"]["scale"], port.get("norm_eps", 1e-5))
    return pr.mm(x, w["head"])


def loss(w: dict, port: dict, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, float32."""
    lg = logits(w, port, tokens)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), targets.reshape(-1).long())
