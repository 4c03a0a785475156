"""Training steps of the program's compiled train step
(``make_graphed_train_step``: forward, backward and the donated AdamW
update, one CUDA graph replayed a step), on batches of the traffic's
bigram stream, every row of every step a new one.

Set-up builds one step, one parameter set and one AdamW state, and drives
them through their first three steps with the window's own call and feed
(the first runs eagerly, the second captures): the reference follows
those three.  The window goes on from step four.

End to end: ``train_tok_s``, the tokens of every step the window ran over
its seconds (first event to last).

The check follows the first three steps, and the window's first
``WINDOW_CHECKED`` steps after them, with the plain reference, and
compares, each as a share of the reference's value:

* ``loss_gap``: each of those steps' losses, the worst: a window step's
  loss is that of the parameters the replays before it wrote;
* ``grad_gap``: the norm of each leaf's first gradient as the optimizer
  got it (clipped), worked out from its first moment after one step,
  ``m / (1 - beta1)``; the worst leaf, against the larger of the leaf's
  norm and the median leaf's;
* ``update_gap``: the norm of each leaf's change after three steps, the
  same way; leaves whose reference gradient is under a thousandth of the
  median leaf's are left out (they move under AdamW by rounding alone).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import spec, stats, weights
from portbench.trace import span
from portbench.traffic import Traffic

WARM_STEPS = 3
#: the window's first steps whose losses the reference follows too
WINDOW_CHECKED = 3


def _device_batch(run, step: int) -> dict:
    b = run.state["traffic"].batch(step)
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(v)
        if run.on_card:
            t = t.pin_memory()
        out[k] = t.to(run.device, non_blocking=True)
    return out


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {k: torch.linalg.vector_norm(v.float()) * scale for k, v in weights.leaves(tree).items()}


def setup(run):
    from repro_torch.launch import train as launch
    from repro_torch.models.model import build_model
    from repro_torch.optim import optimizer
    from repro_torch.train import train_step

    cfg = spec.model_config(run.conf)
    model = build_model(cfg)
    rt = launch.runtime(run.on_card, run.cell["remat"])
    opt_cfg = optimizer.OptimizerConfig(**run.cell["optimizer"])
    if run.on_card:
        step = train_step.make_graphed_train_step(model, opt_cfg, rt)
    else:
        step = train_step.make_train_step(model, opt_cfg, rt, donate=True)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[run.conf["dtype"]]
    w = weights.make(run.conf, run.seed, dtype, run.device)
    opt = optimizer.adamw_init(w, opt_cfg)
    run.state.update(step=step, weights=w, opt=opt, opt_cfg=opt_cfg,
                     traffic=Traffic(run.cell["traffic"], cfg.vocab_size, run.seed))
    losses = []
    for i in range(WARM_STEPS):
        _, _, metrics = step(w, opt, _device_batch(run, i))
        losses.append(metrics["loss"].detach().clone())
        if i == 0:  # the first gradient as the optimizer got it
            grads = _norms(opt["m"], 1.0 / (1.0 - opt_cfg.beta1))
    start = weights.leaves(weights.make(run.conf, run.seed, dtype, run.device))  # made again
    change = {k: torch.linalg.vector_norm(v.float() - start[k].float())
              for k, v in weights.leaves(w).items()}
    del start
    run.state["program"] = {"loss": losses, "grad": grads, "change": change}


def window(run, seconds: float):
    step, w, opt = run.state["step"], run.state["weights"], run.state["opt"]
    p = run.cell["traffic"]
    end = time.perf_counter() + seconds
    losses, marks = [], []
    i = WARM_STEPS
    batch = _device_batch(run, i)
    first = run.mark()
    while True:
        with span("train", run.trace):
            a = run.mark()
            _, _, metrics = step(w, opt, batch)
            b = run.mark()
        run.span("train", a, b)
        marks.append(b)
        losses.append(metrics["loss"].detach().clone())
        i += 1
        if time.perf_counter() >= end:
            break
        with span("feed", run.trace):
            batch = _device_batch(run, i)  # drawn while the device runs
    run.sync()
    window_s = run.ms(first, marks[-1]) / 1e3
    n = len(marks)
    run.e2e.update(train_tok_s=stats.rate(n * p["batch"] * p["seq"], window_s), _window_s=window_s)
    run.attempted = n
    run.failed = int(sum(not np.isfinite(float(x)) for x in losses))
    run.work["train_steps"] = [(p["batch"], p["seq"])] * n
    run.state["program"]["loss"] += losses[:WINDOW_CHECKED]
    run.notes.append(f"{n} steps of {p['batch']} x {p['seq']} tokens in {window_s:.4f} s; "
                     f"losses {float(losses[0]):.6f} .. {float(losses[-1]):.6f}")


def release(run):
    import gc

    step = run.state.pop("step")
    if hasattr(step, "release"):
        step.release()
    for k in ("weights", "opt"):
        run.state.pop(k)
    del step
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def reference_steps(run, steps: int, tf32: bool = False) -> dict:
    """The plain reference's first ``steps`` steps from the seed's weights
    and batches: their losses, the first gradients' norms (clipped) and the
    changes' norms after ``WARM_STEPS`` steps, by leaf."""
    from portbench.reference import adamw
    from portbench.reference.common import precision

    ref = spec.reference(run.conf["reference"])
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[run.conf["dtype"]]
    with precision(tf32=tf32):
        w = weights.make(run.conf, run.seed, dtype, run.device)
        names = list(weights.leaves(w))
        p0 = [t.detach().float() for t in weights.leaves(w).values()]  # read, never written
        params = [t.clone().requires_grad_(True) for t in p0]
        opt = adamw.AdamW(run.cell["optimizer"], params)
        tree = _rebuild(w, names, params)
        losses = []
        for i in range(steps):
            b = _device_batch(run, i)
            loss = ref.loss(tree, run.conf["port"], b["tokens"], b["targets"])
            losses.append(loss.detach())
            if i == steps - 1 and i >= WARM_STEPS:
                break  # the last loss compared needs no update after it
            grads = torch.autograd.grad(loss, params)
            clip = opt.step(grads)
            if i == 0:
                grad = {n: torch.linalg.vector_norm(g) * clip for n, g in zip(names, grads)}
            if i == WARM_STEPS - 1:
                change = {n: torch.linalg.vector_norm(p.detach() - q)
                          for n, p, q in zip(names, params, p0)}
            del grads, loss
    return {"loss": losses, "grad": grad, "change": change}


def _rebuild(tree: dict, names, tensors) -> dict:
    out: dict = {}
    for name, t in zip(names, tensors):
        node = out
        parts = name.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t
    return out


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    rv = {n: float(ref[n]) for n in names}
    med = float(np.median(list(rv.values())))
    return max(abs(float(prog[n]) - rv[n]) / max(rv[n], med, 1e-30) for n in names)


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers compared (see the module's docstring)."""
    loss = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(prog["loss"], ref["loss"]))
    grad_med = float(np.median([float(v) for v in ref["grad"].values()]))
    moved = lambda n: float(ref["grad"][n]) >= 1e-3 * grad_med
    return {"loss_gap": loss, "grad_gap": _leaf_gap(prog["grad"], ref["grad"]),
            "update_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def check(run):
    ref = reference_steps(run, len(run.state["program"]["loss"]))
    run.state["reference"] = ref
    got = compare(run.state["program"], ref)
    limits = run.cell["limits"]
    return [(k, got[k], limits[k]) for k in ("loss_gap", "grad_gap", "update_gap")]


def control(run):
    """The control's readings: the reference with TF32 products in the
    program's place."""
    return compare(reference_steps(run, len(run.state["reference"]["loss"]), tf32=True),
                   run.state["reference"])
