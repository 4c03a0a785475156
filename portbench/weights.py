"""The weights of a cell, made from ``--seed`` on the device, in the program's
parameter layout and in the type they are served or trained in.

Every drawn leaf is a view of one flat buffer filled by one ``normal_``
call of a ``torch.Generator`` on the device (truncated at two standard
deviations, then scaled by ``1 / sqrt(fan_in)`` leaf by leaf), and the
token-shift mixes by one ``uniform_`` call: the same seed gives the same
tensors, so the reference is handed these tensors or the same ones made
again.  Norm scales are ones; the rows of the embedding past the
published vocabulary (the program pads it to a multiple of 256) are
zeros, as a real checkpoint's padding is, so no served token lies there.

The layout is the program's (``models/lm.py``): leaves stacked along a
leading layer dim, one period position (``pos0``) as both families here
have a period of one layer.  ``portbench/tests`` holds it to
``Model.init``'s tree, leaf for leaf.
"""
from __future__ import annotations

import math

import torch

from portbench import seeds


def _plan(conf: dict) -> list:
    """``(path, shape, kind, scale)`` of every leaf; ``kind`` is ``normal``
    (scale = its standard deviation), ``uniform``, ``ones``, ``zeros`` or
    ``ramp``."""
    p = conf["port"]
    D, L, F = p["d_model"], p["num_layers"], p["d_ff"]
    V = -(-p["vocab_size"] // p.get("vocab_pad_multiple", 256)) * p.get("vocab_pad_multiple", 256)
    out = [(("embed",), (V, D), "normal", 1 / math.sqrt(D)),
           (("final_norm", "scale"), (D,), "ones", 0)]
    if not p.get("tie_embeddings", False):
        out.append((("head",), (D, V), "normal", 1 / math.sqrt(D)))
    blk = ("blocks", "pos0")
    out.append((blk + ("norm1", "scale"), (L, D), "ones", 0))
    norm2 = (blk + ("norm2", "scale"), (L, D), "ones", 0)
    if p.get("rwkv"):
        rc = p["rwkv"]
        hs, ml, dl = rc["head_size"], rc["mix_lora"], rc["decay_lora"]
        H = D // hs
        m = blk + ("mixer",)
        out += [(m + ("mu",), (L, 5, D), "uniform", 0),
                (m + ("mix_w1",), (L, D, 5 * ml), "normal", 0.1 / math.sqrt(D)),
                (m + ("mix_w2",), (L, 5, ml, D), "normal", 0.1 / math.sqrt(ml)),
                (m + ("w_lora1",), (L, D, dl), "normal", 0.1 / math.sqrt(D)),
                (m + ("w_lora2",), (L, dl, D), "normal", 0.1 / math.sqrt(dl)),
                (m + ("w_bias",), (L, D), "ramp", 0)]
        out += [(m + (w,), (L, D, D), "normal", 1 / math.sqrt(D))
                for w in ("wr", "wk", "wv", "wg", "wo")]
        out += [(m + ("u",), (L, H, hs), "normal", 0.5),
                (m + ("ln_x", "scale"), (L, D), "ones", 0),
                (m + ("ln_x", "bias"), (L, D), "zeros", 0)]
        c = blk + ("mlp",)
        out += [norm2, (c + ("mu_k",), (L, D), "uniform", 0), (c + ("mu_r",), (L, D), "uniform", 0),
                (c + ("wk",), (L, D, F), "normal", 1 / math.sqrt(D)),
                (c + ("wv",), (L, F, D), "normal", 1 / math.sqrt(F)),
                (c + ("wr",), (L, D, D), "normal", 1 / math.sqrt(D))]
        return out
    H, K = p["num_heads"], p["num_kv_heads"]
    dh = p.get("head_dim") or D // H
    m = blk + ("mixer",)
    out += [(m + ("wq",), (L, D, H, dh), "normal", 1 / math.sqrt(D)),
            (m + ("wk",), (L, D, K, dh), "normal", 1 / math.sqrt(D)),
            (m + ("wv",), (L, D, K, dh), "normal", 1 / math.sqrt(D)),
            (m + ("wo",), (L, H, dh, D), "normal", 1 / math.sqrt(H * dh))]
    if p.get("qkv_bias"):
        out += [(m + ("bq",), (L, H, dh), "normal", 0.02),
                (m + ("bk",), (L, K, dh), "normal", 0.02),
                (m + ("bv",), (L, K, dh), "normal", 0.02)]
    c = blk + ("mlp",)
    out += [norm2, (c + ("w_gate",), (L, D, F), "normal", 1 / math.sqrt(D)),
            (c + ("w_up",), (L, D, F), "normal", 1 / math.sqrt(D)),
            (c + ("w_down",), (L, F, D), "normal", 1 / math.sqrt(F))]
    return out


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(conf: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The parameter tree of ``conf`` from ``seed``: nested dicts of tensors,
    as ``split_params(model.init(...))[0]`` gives them."""
    plan = _plan(conf)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "weights"))
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in plan if k == kind)
             for kind in ("normal", "uniform")}
    flat = {kind: torch.empty(n, dtype=dtype, device=device) for kind, n in sizes.items()}
    flat["normal"].normal_(generator=gen).clamp_(-2.0, 2.0)
    flat["uniform"].uniform_(generator=gen)
    at = {"normal": 0, "uniform": 0}
    tree: dict = {}
    for path, shape, kind, scale in plan:
        n = math.prod(shape)
        if kind in at:
            t = flat[kind][at[kind]:at[kind] + n].view(shape)
            at[kind] += n
            if kind == "normal":
                t.mul_(scale)
        elif kind == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:  # the program's decay bias: a ramp from -6 to -1 along d_model
            D = shape[-1]
            ramp = -6.0 + 5.0 * torch.arange(D, dtype=torch.float32, device=device) / max(D - 1, 1)
            t = ramp.to(dtype).expand(shape).contiguous()
        _put(tree, path, t)
    vocab = conf["port"]["vocab_size"]
    tree["embed"][vocab:].zero_()
    if "head" in tree:
        tree["head"][:, vocab:].zero_()
    return tree


def leaves(tree: dict, prefix: str = "") -> dict:
    """``{"a/b/c": tensor}`` of a nested dict, in insertion order."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(leaves(v, name))
        else:
            out[name] = v
    return out

