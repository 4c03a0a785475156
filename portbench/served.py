"""What the serving drivers share: the program's served steps as the cell's
device asks for them, and the check of served tokens against the plain
reference.

The check: for a sample of the finished requests drawn from the seed (the
longest among them), the reference is run once over each request's prompt
and served tokens, and the number compared is the widest gap by which a
served token's logit lies below the reference's best at its position.
The tokens are greedy, so a sound program's gap is rounding alone.  The
control (``control_gaps``) is the same reference in a lower precision: at
each position its first token, read by the float32 reference's gap.
Where a cell compares the cache its steps wrote, ``cache_gap`` reads the
written keys and values against the reference's, position by position.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from portbench import seeds


def program(run):
    """The program's model, runtime and step builders for this run: the
    compiled steps on the card (as ``launch/serve.py`` serves), the eager
    ones elsewhere (the CPU runs of the tests)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models.model import build_model
    from repro_torch.serve import serve_step

    from portbench import spec

    cfg = spec.model_config(run.conf)
    model = build_model(cfg)
    rt = launch.runtime(run.on_card, run.conf["dtype"])
    if run.on_card:
        prefill = serve_step.make_graphed_prefill_step(model, rt)
        decode = serve_step.make_graphed_decode_step(model, rt)
    else:
        prefill = serve_step.make_prefill_step(model, rt)
        decode = serve_step.make_decode_step(model, rt)
    return model, rt, prefill, decode


def host(array, run) -> torch.Tensor:
    """``array`` as a host tensor, pinned on the card (so that its copy to
    the device does not wait for the host)."""
    t = torch.from_numpy(array)
    return t.pin_memory() if run.on_card else t


def dtype(run) -> torch.dtype:
    return {"bf16": torch.bfloat16, "f32": torch.float32}[run.conf["dtype"]]


def sample(run, finished: Sequence, longest: int, n: int, stream: str = "sample") -> List:
    """``n`` of the ``finished`` requests drawn from the seed (its ``stream``),
    the one at index ``longest`` among them."""
    r = seeds.rng(run.seed, stream)
    rest = [i for i in range(len(finished)) if i != longest]
    picked = [longest] + sorted(r.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist())
    return [finished[i] for i in picked]


def gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """``max(ref) - ref[served]`` at every position; ``ref`` (N, T, V),
    ``served`` (N, T)."""
    ref = ref.float()
    return ref.amax(-1) - ref.gather(-1, served.long()[..., None].to(ref.device))[..., 0]


def control_gaps(ref: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The reference's gap of the token the lower precision puts first."""
    return gaps(ref, low.argmax(-1))


def cache_gap(written: torch.Tensor, ref: torch.Tensor) -> float:
    """How far the keys or values ``written`` (layers, positions, heads, dh)
    lie from the reference's ``ref``: at each layer and position, the norm
    of the difference over the norm of the reference's vector or the
    layer's median one, whichever is larger; the worst."""
    ref = ref.float()
    diff = (written.float().to(ref.device) - ref).flatten(2).norm(dim=-1)
    norm = ref.flatten(2).norm(dim=-1)
    med = norm.median(dim=1, keepdim=True).values
    return float((diff / torch.maximum(norm, med).clamp(min=1e-30)).max())


def release(run, *names) -> None:
    """Drops the program's compiled steps and state named in ``run.state``."""
    import gc

    for name in names:
        obj = run.state.pop(name, None)
        if hasattr(obj, "release"):
            obj.release()
        del obj
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
