"""Long cached contexts asked again: ``sessions`` sequences whose first
``context`` positions are already in the program's KV cache, and turn
after turn every session gets a fresh first token and decodes ``gen``
greedy tokens through the program's compiled decode step, from position
``context``.  Each turn rewinds the position, so it overwrites the slots
the last turn wrote: users asking again over one long document.

The cached keys and values are made on the device from the seed, layer by
layer (standard normal values; the keys scaled by ``k_std`` so that a
query attends to a few positions spread over the whole context rather
than to their mean): prefilling ``sessions x context`` tokens every run
would cost set-up that no request of the window needs.  The reference is
given the same keys and values, made again from the seed.

End to end: ``gen_tok_s`` (tokens over the window, first event to last)
and ``tpot_p95_ms`` (every gap between a request's consecutive tokens,
from device events recorded after each step).
"""
from __future__ import annotations

import time

import torch

from portbench import seeds, served, spec, stats, weights
from portbench.trace import span
from portbench.traffic import Traffic


def _context(run, layer: int, which: str, shape, device, dtype) -> torch.Tensor:
    """The cached ``which`` ("k" or "v") of ``layer`` for every session and
    slot, from the seed."""
    p = run.cell["traffic"]
    g = torch.Generator(device=device)
    g.manual_seed(seeds.derive(run.seed, "context", layer, which))
    t = torch.empty(shape, dtype=dtype, device=device).normal_(generator=g)
    return t.mul_(p["k_std"]) if which == "k" else t


def setup(run):
    from repro_torch.models.params import split_params
    from repro_torch.serve import serve_step

    p = run.cell["traffic"]
    model, rt, _, decode = served.program(run)
    w = weights.make(run.conf, run.seed, served.dtype(run), run.device)
    cache = split_params(model.init_cache(p["sessions"], p["cache_len"], device=run.device))[0]
    mixer = cache["layers"]["pos0"]["mixer"]
    for l in range(run.conf["port"]["num_layers"]):
        for which in ("k", "v"):
            leaf = mixer[which][l]
            leaf.copy_(_context(run, l, which, leaf.shape, run.device, leaf.dtype))
    run.state["context_dtype"] = mixer["k"].dtype
    traffic = Traffic(p, run.conf["port"]["vocab_size"], run.seed)
    run.state.update(decode=decode, weights=w, cache=cache, traffic=traffic)
    # warm-up: the first call runs eagerly, the second captures, the third replays
    tok = torch.from_numpy(traffic.turn(-1)).to(run.device)[:, None]
    c = {"pos": p["context"], "layers": cache["layers"]}
    for _ in range(3):
        logits, c = decode(w, tok, c)
        tok = serve_step.greedy_sample(logits)


def window(run, seconds: float):
    from repro_torch.serve import serve_step

    p = run.cell["traffic"]
    decode, w, cache = run.state["decode"], run.state["weights"], run.state["cache"]
    traffic = run.state["traffic"]
    S, G = p["sessions"], p["gen"]
    turns = []
    end = time.perf_counter() + seconds
    first = run.mark()
    nxt = served.host(traffic.turn(0), run)
    while True:
        j = len(turns)
        start = nxt
        tok = start.to(run.device, non_blocking=True)[:, None]
        out = torch.empty((S, G), dtype=torch.int32, device=run.device)
        c = {"pos": p["context"], "layers": cache["layers"]}
        marks = []
        for i in range(G):
            with span("decode", run.trace):
                a = run.mark()
                logits, c = decode(w, tok, c)
                b = run.mark()
            tok = serve_step.greedy_sample(logits)
            out[:, i:i + 1] = tok
            marks.append(run.mark())
            run.span("decode", a, b)
        nxt = served.host(traffic.turn(j + 1), run)  # drawn while the device runs
        with span("readback", run.trace):
            turns.append((start.numpy(), out.cpu(), marks))
        if time.perf_counter() >= end:
            break
    run.sync()
    window_s = run.ms(first, turns[-1][2][-1]) / 1e3
    gaps = []
    for _, _, marks in turns:
        for i in range(1, G):
            gaps += [run.ms(marks[i - 1], marks[i])] * S
    run.e2e.update(gen_tok_s=stats.rate(S * G * len(turns), window_s),
                   tpot_p95_ms=stats.percentile(gaps, 95), _window_s=window_s)
    run.notes.append(f"{len(turns)} turns of {S} sessions x {G} tokens in {window_s:.4f} s; "
                     f"{len(gaps)} token gaps")
    run.attempted = S * len(turns)
    run.work["decode_steps"] = [(S, p["context"] + i + 1) for _ in turns for i in range(G)]
    run.state["turns"] = [(s, o) for s, o, _ in turns]


def release(run):
    served.release(run, "decode", "cache")


def _reference_logits(run, picked, products=None):
    """The reference's logits at every served position of the ``picked``
    requests (turn, session)."""
    p = run.cell["traffic"]
    port = run.conf["port"]
    ref = spec.reference(run.conf["reference"])
    w = run.state["weights"]
    turns = run.state["turns"]
    rows = torch.tensor([b for _, b in picked], device=run.device)
    tokens = torch.stack([torch.cat([torch.tensor(turns[j][0][b:b + 1]), turns[j][1][b, :-1].long()])
                          for j, b in picked]).to(run.device)
    K = port["num_kv_heads"]
    dh = port.get("head_dim") or port["d_model"] // port["num_heads"]
    shape = (p["sessions"], p["cache_len"], K, dh)

    def context(layer):
        return tuple(_context(run, layer, which, shape, run.device,
                              run.state["context_dtype"])[rows, :p["context"]]
                     for which in ("k", "v"))

    return ref.logits(w, port, tokens, first=p["context"], context=context, products=products)


def _served(run, picked):
    return torch.stack([run.state["turns"][j][1][b] for j, b in picked])


def check(run):
    from portbench.reference.common import precision

    turns = run.state["turns"]
    finished = [(j, b) for j in range(len(turns)) for b in range(run.cell["traffic"]["sessions"])]
    picked = served.sample(run, finished, 0, run.cell["sample"])
    run.state["picked"] = picked
    with precision(tf32=False), torch.no_grad():
        ref = _reference_logits(run, picked)
    run.state["reference"] = ref
    gap = float(served.gaps(ref, _served(run, picked)).max())
    return [("logit_gap", gap, run.cell["limits"]["logit_gap"])]


def control(run):
    """The control's reading: the reference in float8, on the same prompts
    and served tokens."""
    from portbench.reference.common import Products, precision

    with precision(tf32=False), torch.no_grad():
        low = _reference_logits(run, run.state["picked"], Products("fp8"))
    return {"logit_gap": float(served.control_gaps(run.state["reference"], low).max())}
