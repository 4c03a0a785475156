"""Waves of requests served as the program's ``launch/serve.py`` serves them
(its loop, copied here so that it can be timed): ``batch`` prompts packed
left-padded to ``pad_to`` tokens, the cache zeroed in place
(``reset_cache``), one compiled prefill, then ``gen - 1`` compiled decode
steps with greedy tokens, and the wave's tokens read back to the host
before the next wave is admitted.  The next wave's prompts are drawn while
the device runs this one.

End to end: ``gen_tok_s`` (tokens over the window, first event to last),
``ttft_p95_ms`` (each request, from the event recorded as its wave's
prompts are enqueued to the event after its first token) and
``tpot_p95_ms`` (every gap between a request's consecutive tokens).  The
work the per-layer readers count is the prompts' own lengths, not the
padding (``prefill_tokens``: the prompts' tokens and the slots they were
packed into).

The check: the served tokens of a sample of the finished requests against
the reference (``served.py``), and, where the cell has a ``cache_gap``
limit, the cache the window's last wave left: the keys and values its
prefill wrote at every prompt position and its decode steps wrote at
slots ``pad_to .. pad_to + gen - 2``, for ``cache_sample`` of its rows
drawn from the seed (its longest among them), against the keys and values
the reference works out over the same tokens.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import served, spec, stats, weights
from portbench.trace import span
from portbench.traffic import Traffic


def _wave(run, tokens, record: bool):
    """One wave on the program; returns (admission mark, mark after each
    token, the tokens on the device)."""
    from repro_torch.serve import serve_step

    p = run.cell["traffic"]
    prefill, decode = run.state["prefill"], run.state["decode"]
    w, cache = run.state["weights"], run.state["cache"]
    out = torch.empty((p["batch"], p["gen"]), dtype=torch.int32, device=run.device)
    with span("admit", run.trace):
        adm = run.mark()
        batch = {"tokens": tokens.to(run.device, non_blocking=True)}
        cache = serve_step.reset_cache(cache)
    with span("prefill", run.trace):
        a = run.mark()
        logits, cache = prefill(w, batch, cache)
        b = run.mark()
    if record:
        run.span("prefill", a, b)
    tok = serve_step.greedy_sample(logits)
    out[:, :1] = tok
    marks = [run.mark()]
    for i in range(1, p["gen"]):
        with span("decode", run.trace):
            a = run.mark()
            logits, cache = decode(w, tok, cache)
            b = run.mark()
        if record:
            run.span("decode", a, b)
        tok = serve_step.greedy_sample(logits)
        out[:, i:i + 1] = tok
        marks.append(run.mark())
    run.state["cache"] = cache
    return adm, marks, out


def setup(run):
    from repro_torch.models.params import split_params

    p = run.cell["traffic"]
    model, rt, prefill, decode = served.program(run)
    w = weights.make(run.conf, run.seed, served.dtype(run), run.device)
    cache = split_params(model.init_cache(p["batch"], p["pad_to"] + p["gen"],
                                          device=run.device))[0]
    traffic = Traffic(p, run.conf["port"]["vocab_size"], run.seed)
    run.state.update(prefill=prefill, decode=decode, weights=w, cache=cache, traffic=traffic)
    # warm-up on a wave of its own: the first prefill and decode run eagerly,
    # the second of each captures; the decode graph is captured in wave one
    warm = served.host(traffic.wave(-1).tokens, run)
    _wave(run, warm, record=False)
    _wave(run, warm, record=False)


def window(run, seconds: float):
    p = run.cell["traffic"]
    traffic = run.state["traffic"]
    B, G = p["batch"], p["gen"]
    waves, ttft, gaps = [], [], []
    end = time.perf_counter() + seconds
    nxt = traffic.wave(0)
    nxt_tokens = served.host(nxt.tokens, run)
    first = run.mark()
    while True:
        wave = nxt
        adm, marks, out = _wave(run, nxt_tokens, record=True)
        # the next wave drawn and pinned while the device runs this one
        nxt = traffic.wave(len(waves) + 1)
        nxt_tokens = served.host(nxt.tokens, run)
        with span("readback", run.trace):
            waves.append((wave, out.cpu(), adm, marks))
        if time.perf_counter() >= end:
            break
    run.sync()
    for _, _, adm, marks in waves:
        ttft += [run.ms(adm, marks[0])] * B
        for i in range(1, G):
            gaps += [run.ms(marks[i - 1], marks[i])] * B
    window_s = run.ms(first, waves[-1][3][-1]) / 1e3
    run.e2e.update(gen_tok_s=stats.rate(B * G * len(waves), window_s),
                   ttft_p95_ms=stats.percentile(ttft, 95), _window_s=window_s)
    if gaps:
        run.e2e["tpot_p95_ms"] = stats.percentile(gaps, 95)
    steps = {k: sum(v) / len(v) for k in ("prefill", "decode") if (v := run.span_ms(k))}
    run.notes.append(f"{len(waves)} waves of {B} requests x {G} tokens in {window_s:.4f} s; "
                     f"{len(ttft)} first tokens, {len(gaps)} token gaps; mean step ms {steps}")
    run.attempted = B * len(waves)
    lengths = [tuple(int(n) for n in wv.lengths) for wv, _, _, _ in waves]
    run.work["prefill_steps"] = [(B, n) for n in lengths]
    run.work["decode_steps"] = [(B, tuple(x + i for x in n)) for n in lengths for i in range(1, G)]
    run.work["prefill_tokens"] = (sum(map(sum, lengths)), B * p["pad_to"] * len(waves))
    run.state["waves"] = [(wv, out) for wv, out, _, _ in waves]


def _cache_rows(run):
    """The rows of the last wave whose cache is compared, drawn from the
    seed, its longest among them."""
    wave = run.state["waves"][-1][0]
    rows = list(range(len(wave.lengths)))
    return served.sample(run, rows, int(np.argmax(wave.lengths)), run.cell["cache_sample"],
                         stream="cache")


def release(run):
    if "cache_gap" in run.cell["limits"]:
        # what the last wave's steps wrote, kept for the check: every slot
        # up to the last one a decode step wrote
        p = run.cell["traffic"]
        rows = _cache_rows(run)
        mixer = run.state["cache"]["layers"]["pos0"]["mixer"]
        n = p["pad_to"] + p["gen"] - 1
        run.state["written"] = {"rows": rows, "k": mixer["k"][:, rows, :n].clone(),
                                "v": mixer["v"][:, rows, :n].clone()}
    served.release(run, "prefill", "decode", "cache")


def _picked(run):
    waves = run.state["waves"]
    finished = [(j, b) for j in range(len(waves)) for b in range(run.cell["traffic"]["batch"])]
    longest = max(range(len(finished)),
                  key=lambda i: waves[finished[i][0]][0].lengths[finished[i][1]])
    return served.sample(run, finished, longest, run.cell["sample"])


def _reference(run, picked, products=None, kv=()):
    """The reference's logits at every served position of the ``picked``
    requests (wave, row), one request at a time, and for those in ``kv``
    the keys and values it stores at every position, (layers, positions,
    heads, dh) each."""
    p = run.cell["traffic"]
    ref = spec.reference(run.conf["reference"])
    waves = run.state["waves"]
    at = torch.arange(p["pad_to"] - 1, p["pad_to"] + p["gen"] - 1, device=run.device)
    out, stored = [], {}
    for j, b in picked:
        wave, toks = waves[j]
        seq = np.concatenate([wave.tokens[b], toks[b, :-1].numpy()])
        tokens = torch.from_numpy(seq.astype(np.int64))[None].to(run.device)
        keep = None
        if (j, b) in kv:
            ks, vs = stored.setdefault((j, b), ([], []))
            keep = lambda l, k, v, ks=ks, vs=vs: (ks.append(k[0]), vs.append(v[0]))
        out.append(ref.logits(run.state["weights"], run.conf["port"], tokens, at=at,
                              products=products, keep=keep)[0])
    stored = {r: (torch.stack(ks), torch.stack(vs)) for r, (ks, vs) in stored.items()}
    return torch.stack(out), stored


def _cache_gaps(run, stored) -> float:
    """The worst ``cache_gap`` of the kept rows' keys and values against
    ``stored``."""
    wr = run.state["written"]
    last = len(run.state["waves"]) - 1
    worst = 0.0
    for i, b in enumerate(wr["rows"]):
        k, v = stored[(last, b)]
        worst = max(worst, served.cache_gap(wr["k"][:, i], k), served.cache_gap(wr["v"][:, i], v))
    return worst


def check(run):
    from portbench.reference.common import precision

    picked = _picked(run)
    limits = run.cell["limits"]
    kv = ()
    if "cache_gap" in limits:
        last = len(run.state["waves"]) - 1
        kv = [(last, b) for b in run.state["written"]["rows"]]
        picked += [r for r in kv if r not in picked]
    run.state["picked"], run.state["kv"] = picked, kv
    with precision(tf32=False), torch.no_grad():
        ref, stored = _reference(run, picked, kv=kv)
    run.state["reference"], run.state["stored"] = ref, stored
    served_toks = torch.stack([run.state["waves"][j][1][b] for j, b in picked])
    out = [("logit_gap", float(served.gaps(ref, served_toks).max()), limits["logit_gap"])]
    if kv:
        out.append(("cache_gap", _cache_gaps(run, stored), limits["cache_gap"]))
    return out


def control(run):
    """The control's readings: the reference in float8, on the same prompts
    and served tokens, and the keys and values it stores."""
    from portbench.reference.common import Products, precision

    with precision(tf32=False), torch.no_grad():
        low, low_kv = _reference(run, run.state["picked"], Products("fp8"), kv=run.state["kv"])
    got = {"logit_gap": float(served.control_gaps(run.state["reference"], low).max())}
    if low_kv:
        got["cache_gap"] = max(served.cache_gap(low_kv[r][i], run.state["stored"][r][i])
                               for r in low_kv for i in (0, 1))
    return got
