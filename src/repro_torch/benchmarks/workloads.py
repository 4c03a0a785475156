"""Tuning workloads mirroring the paper's model variety (§4.1).

| paper model        | domain            | here                          |
|--------------------|-------------------|-------------------------------|
| SSD-MobileNet      | vision            | `convnet` (dw-separable CNN)  |
| ResNet50 (FP32/I8) | vision            | `convnet` precision dim       |
| Transformer-LT     | translation       | `dense_lm` (qwen2)            |
| BERT               | language          | `moe_lm` (qwen3-MoE)          |
| NCF                | recommendation    | `ncf` (embedding + MLP)       |
| —                  | (new) ssm         | `rwkv` (RWKV-6)               |

Each workload exposes
  * ``space``      — its tunable backend parameters (paper Table 1 shape)
  * measured path  — ``measured_make_step(workload)(point)`` for
    ``WallClockEvaluator`` (a real training step on ``device``; the
    paper's measurement harness); ``MeasuredEvaluator`` wraps the two and
    adds what a point ran with to its meta
  * surrogate path — ``surrogate_objective`` — a deterministic analytic
    throughput model (compute/memory two-term roofline + interaction and
    plateau structure + 2% hash noise) used for fast CI and the
    many-seed comparative statistics.

The workload table, ``_hash01`` and the surrogate are the reference
package's, copied: in one process both give the same float for every
point.  ``_hash01`` hashes with Python's ``hash()``, which is salted per
process (``PYTHONHASHSEED``), so the surrogate's 2 % noise differs from
one process to the next; the copy keeps that (ROADMAP, faults of the
reference).

The measured steps run on ``device`` (``"cuda"`` by default, raising when
there is no card).  The language models train through the port's own
``train_step``: on the CPU with the reference's runtime (f32, chunked
attention); on the card with ``launch.train.runtime`` (the kernels
forward, each with its oracle's backward).  Two departures from the
reference's measured steps:

* ``convnet``'s depthwise convolutions run.  The reference draws their
  kernels as (3, 3, C, 1) in HWIO and passes ``feature_group_count=C``,
  which JAX refuses (the kernel's input dim must be C / C = 1): each of its
  measured convnet points raises.  Here the same numbers are the
  depthwise kernel (C, 1, 3, 3), which is what that layout means.
* ``convnet``'s ``channels_last`` is live: 1 puts the input and the
  weights in ``torch.channels_last``.  A layout changes no value.  The
  reference reads the knob nowhere.

``ncf`` reads only ``batch``, as the reference's step does: its
``microbatches``, ``remat`` and ``embed_block`` tune nothing measured
(the surrogate reads ``embed_block``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.tuning.objective import Evaluator

# --- the five workload definitions -----------------------------------------

_COMMON_DIMS = [
    {"name": "batch", "type": "cat", "choices": [2, 4, 8, 16]},
    {"name": "microbatches", "type": "cat", "choices": [1, 2, 4]},
    {"name": "remat", "type": "cat", "choices": ["none", "dots", "names", "full"]},
]

MEASURED_WORKLOADS = [
    {
        "name": "dense_lm",
        "arch": "qwen2-0.5b",
        "kind": "lm",
        "space": _COMMON_DIMS + [
            {"name": "block_q", "type": "int", "min": 8, "max": 64, "step": 8},
        ],
        # surrogate shape: flops/byte weights + sweet spots
        "surr": {"flop": 1.0, "mem": 0.7, "bq_opt": 32, "mb_cost": 0.06,
                 "remat_gain": 0.25, "mode2": 0.35},
    },
    {
        "name": "moe_lm",
        "arch": "qwen3-moe-30b-a3b",
        "kind": "lm",
        "space": _COMMON_DIMS + [
            {"name": "block_q", "type": "int", "min": 8, "max": 64, "step": 8},
            {"name": "capacity_factor", "type": "cat",
             "choices": [1.0, 1.25, 1.5, 2.0]},
        ],
        "surr": {"flop": 1.1, "mem": 1.0, "bq_opt": 16, "mb_cost": 0.05,
                 "remat_gain": 0.1, "mode2": 0.55, "cf_opt": 1.25},
    },
    {
        "name": "rwkv",
        "arch": "rwkv6-3b",
        "kind": "lm",
        "space": _COMMON_DIMS + [
            {"name": "scan_chunk", "type": "int", "min": 8, "max": 64, "step": 8},
        ],
        "surr": {"flop": 0.9, "mem": 1.2, "bq_opt": 24, "mb_cost": 0.08,
                 "remat_gain": 0.35, "mode2": 0.2, "chunk_dim": "scan_chunk"},
    },
    {
        "name": "convnet",
        "arch": None,
        "kind": "conv",
        "space": _COMMON_DIMS + [
            {"name": "channels_last", "type": "cat", "choices": [0, 1]},
        ],
        "surr": {"flop": 1.3, "mem": 0.8, "bq_opt": 40, "mb_cost": 0.1,
                 "remat_gain": 0.15, "mode2": 0.45},
    },
    {
        "name": "ncf",
        "arch": None,
        "kind": "ncf",
        "space": [
            {"name": "batch", "type": "cat", "choices": [64, 128, 256, 512]},
            {"name": "microbatches", "type": "cat", "choices": [1, 2, 4]},
            {"name": "remat", "type": "cat",
             "choices": ["none", "dots", "names", "full"]},
            {"name": "embed_block", "type": "int", "min": 8, "max": 64, "step": 8},
        ],
        "surr": {"flop": 0.6, "mem": 1.5, "bq_opt": 48, "mb_cost": 0.12,
                 "remat_gain": 0.05, "mode2": 0.25, "bq_dim": "embed_block"},
    },
]


def _hash01(*vals) -> float:
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h ^= abs(hash(v))
        h = (h * 0xBF58476D1CE4E5B9) % (2 ** 64)
        h ^= h >> 31
    return (h % 10_000) / 10_000.0


def surrogate_objective(workload: Dict) -> Callable[[Dict], float]:
    """Analytic two-term throughput model with the qualitative structure
    observed in the paper's Fig. 6 sweep: one dominant parameter, one
    near-flat parameter, a tile-size sweet spot, and a secondary mode."""
    s = workload["surr"]
    bq_dim = s.get("bq_dim", s.get("chunk_dim", "block_q"))

    def f(p: Dict) -> float:
        batch = p["batch"]
        mb = p["microbatches"]
        remat = p["remat"]
        bq = p.get(bq_dim, s["bq_opt"])

        # compute term: larger effective batch = better MXU utilization
        eff = batch / mb
        compute = s["flop"] / (1.0 - math.exp(-eff / 6.0))
        # tile sweet spot (primary mode) + secondary mode at half the tile
        tile = 1.0 + 0.8 * (math.log2(bq / s["bq_opt"])) ** 2 * 0.15
        tile2 = 1.0 + 0.8 * (math.log2(max(bq, 1) / max(s["bq_opt"] // 4, 1))) ** 2 * 0.15
        tile = min(tile, tile2 * (1 + s["mode2"]))
        # memory term: remat trades capacity for recompute
        remat_cost = {"none": 1.0, "dots": 1.05, "names": 1.12, "full": 1.3}[remat]
        fits = eff * (1.0 if remat != "none" else 1.6) <= 18
        mem = s["mem"] * (1.0 if fits else 4.0)  # spill cliff
        # microbatch fixed overhead
        overhead = 1.0 + s["mb_cost"] * (mb - 1)
        if "capacity_factor" in p:
            cf = p["capacity_factor"]
            overhead *= 1.0 + 0.3 * abs(cf - s.get("cf_opt", 1.25))
        step = max(compute * tile * remat_cost, mem) * overhead
        tput = 1000.0 * batch / step
        noise = 1.0 + 0.02 * (_hash01(workload["name"], tuple(sorted(p.items()))) - 0.5)
        return tput * noise

    return f


# --- measured (wall-clock) steps ---------------------------------------------


def lm_config(workload: Dict, *, reduced: bool = True,
              num_layers: Optional[int] = None):
    """The model config a language-model workload trains: the reduced
    config (the reference's setting) or the published one, its depth cut to
    ``num_layers`` when given (width untouched)."""
    from repro_torch.configs import get_config

    cfg = get_config(workload["arch"])
    if reduced:
        cfg = cfg.reduced()
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=int(num_layers))
    return cfg


def lm_params(cfg, *, device, seed: int = 0):
    """f32 weights of ``cfg`` drawn on ``device`` from a ``torch.Generator``
    seeded ``seed``: the value tree ``_lm_make_step`` takes."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.params import split_params

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return split_params(build_model(cfg).init(gen))[0]


def _lm_make_step(workload: Dict, *, device: str = "cuda", reduced: bool = True,
                  seq_len: int = 64, params=None, runtime=None,
                  num_layers: Optional[int] = None):
    """One AdamW train step of the workload's model a measurement.

    ``params`` (a value tree on ``device``) replaces the seeded weights;
    ``runtime`` replaces the base runtime the point's knobs are applied to
    (on the CPU the reference's ``Runtime(compute_dtype="f32",
    attn_impl="chunked")``, on the card ``launch.train.runtime``)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    cfg = lm_config(workload, reduced=reduced, num_layers=num_layers)
    model = build_model(cfg)
    if params is None:
        params = lm_params(cfg, device=device)
    if runtime is None:
        if torch.device(device).type == "cuda":
            from repro_torch.launch.train import runtime as train_runtime

            runtime = train_runtime(True, "none")
        else:
            runtime = Runtime(compute_dtype="f32", attn_impl="chunked")
    opt_cfg = OptimizerConfig(warmup_steps=1)
    opt = adamw_init(params, opt_cfg)
    S = seq_len
    rng = np.random.default_rng(0)

    def make_step(point: Dict):
        B = point["batch"]
        rt = dataclasses.replace(
            runtime,
            remat=point["remat"],
            block_q=point.get("block_q", 32),
            block_kv=point.get("block_q", 32),
            scan_chunk=point.get("scan_chunk", 16),
            moe_capacity_factor=point.get("capacity_factor", 0.0),
        )
        step = make_train_step(model, opt_cfg, rt,
                               microbatches=point["microbatches"])
        batch = {
            "tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(device),
            "targets": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(device),
        }

        def fn(params, opt, batch):
            _, _, m = step(params, opt, batch)
            return m["loss"]

        return fn, (params, opt, batch), float(B * S)

    return make_step


def _grads(loss, ws: Dict) -> Dict:
    """The gradient of ``loss`` for every leaf of ``ws``, as the reference's
    ``jax.grad`` computes them all."""
    import torch

    return dict(zip(ws, torch.autograd.grad(loss, list(ws.values()))))


def _conv_make_step(workload: Dict, *, device: str = "cuda"):
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    rng = np.random.default_rng(0)
    C, H = 16, 32

    def draw(shape):
        return 0.1 * rng.standard_normal(shape)

    # the reference's draws, in its order and layouts (HWIO), turned into
    # torch's (O, I / groups, kH, kW): a depthwise (3, 3, C, 1) is (C, 1, 3, 3)
    hwio = {"dw1": draw((3, 3, C, 1)), "pw1": draw((1, 1, C, 2 * C)),
            "dw2": draw((3, 3, 2 * C, 1)), "pw2": draw((1, 1, 2 * C, 2 * C))}
    head = draw((2 * C, 10))
    base = {k: torch.tensor(v.transpose(2, 3, 0, 1) if k.startswith("dw")
                            else v.transpose(3, 2, 0, 1), dtype=torch.float32)
            for k, v in hwio.items()}
    base["head"] = torch.tensor(head, dtype=torch.float32)
    layouts = {}

    def weights(channels_last: bool):
        if channels_last not in layouts:
            fmt = torch.channels_last if channels_last else torch.contiguous_format
            layouts[channels_last] = {
                k: (v.to(device).contiguous(memory_format=fmt) if v.dim() == 4
                    else v.to(device)).requires_grad_(True)
                for k, v in base.items()}
        return layouts[channels_last]

    def net(ws, x):
        for dw, pw in (("dw1", "pw1"), ("dw2", "pw2")):
            x = F.conv2d(x, ws[dw], padding=1, groups=x.shape[1])
            x = F.relu(F.conv2d(x, ws[pw]))
        x = x.mean(dim=(2, 3))
        return x @ ws["head"]

    def make_step(point: Dict):
        B = point["batch"]
        channels_last = bool(point.get("channels_last", 0))
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = torch.from_numpy(rng.standard_normal((B, H, H, C)).astype(np.float32))
        x = x.permute(0, 3, 1, 2).to(device).contiguous(memory_format=fmt)
        y = torch.from_numpy(rng.integers(0, 10, (B,)).astype(np.int32)).to(device)

        def inner(ws, x, y):
            logits = net(ws, x)
            return -torch.gather(F.log_softmax(logits, dim=-1), 1,
                                 y.long()[:, None]).mean()

        def f(ws, x, y):
            if point["remat"] != "none":
                return checkpoint(inner, ws, x, y, use_reentrant=False)
            return inner(ws, x, y)

        def loss_fn(ws):
            if point["microbatches"] > 1:
                k = point["microbatches"]
                if B % k == 0:
                    losses = [f(ws, x[i::k], y[i::k]) for i in range(k)]
                    return sum(losses) / k
            return f(ws, x, y)

        def fn(ws):
            return _grads(loss_fn(ws), ws)["head"].sum()

        return fn, (weights(channels_last),), float(B)

    return make_step


def _ncf_make_step(workload: Dict, *, device: str = "cuda"):
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    n_users, n_items, dim = 2000, 3000, 32
    shapes = {"ue": (n_users, dim), "ie": (n_items, dim), "w1": (2 * dim, 64),
              "w2": (64, 1)}
    ws = {k: torch.tensor(0.1 * rng.standard_normal(s), dtype=torch.float32)
          .to(device).requires_grad_(True) for k, s in shapes.items()}

    def make_step(point: Dict):
        B = point["batch"]

        def draw(hi, dtype):
            return torch.from_numpy(rng.integers(0, hi, (B,)).astype(dtype)).to(device)

        u = draw(n_users, np.int32)
        i = draw(n_items, np.int32)
        y = draw(2, np.float32)

        def loss_fn(ws):
            ue = ws["ue"][u.long()]
            ie = ws["ie"][i.long()]
            h = F.relu(torch.cat([ue, ie], -1) @ ws["w1"])
            logit = (h @ ws["w2"])[:, 0] + (ue * ie).sum(-1)
            return torch.mean(torch.logaddexp(torch.zeros_like(logit), logit) - y * logit)

        def fn(ws):
            return _grads(loss_fn(ws), ws)["w1"].sum()

        return fn, (ws,), float(B)

    return make_step


def measured_make_step(workload: Dict, *, device: str = "cuda", **kwargs):
    """``make_step(point) -> (fn, args, work)`` of the workload's measured
    step on ``device``; ``kwargs`` go to the language models' ``_lm_make_step``
    (``reduced``, ``seq_len``, ``params``, ``runtime``, ``num_layers``)."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device cuda (the default) needs an NVIDIA GPU and none is visible; "
            "pass device='cpu' to measure on the CPU")
    if workload["kind"] == "lm":
        return _lm_make_step(workload, device=device, **kwargs)
    if kwargs:
        raise TypeError(f"{workload['name']} takes no {sorted(kwargs)}")
    if workload["kind"] == "conv":
        return _conv_make_step(workload, device=device)
    if workload["kind"] == "ncf":
        return _ncf_make_step(workload, device=device)
    raise ValueError(workload["kind"])


class MeasuredEvaluator(Evaluator):
    """``WallClockEvaluator(measured_make_step(workload, ...))``, the
    reference's measured objective, with what each point ran with in its
    meta: the attention tiles after the kernel's wrapper clamped the request
    (``attn_config``, ``attn_kernel``: ``flash_attention.last_config`` and
    ``last_kernel``, where the step ran attention), and on the card the
    point's peak device bytes (``peak_bytes``).  A point that runs out of
    device memory scores ``-inf`` with ``oom`` in its meta, as a failed run
    scores in the reference's harness."""

    supports_fidelity = True

    def __init__(self, workload: Dict, *, device: str = "cuda", iters: int = 2, **build):
        from repro_torch.tuning.evaluator import WallClockEvaluator

        self.workload = workload
        self.device = device
        self._wall = WallClockEvaluator(
            measured_make_step(workload, device=device, **build), iters=iters)

    def __call__(self, point: Dict, fidelity: Optional[float] = None):
        import torch

        from repro_torch.kernels.flash_attention import flash_attention

        on_card = torch.device(self.device).type == "cuda"
        flash_attention.last_config = flash_attention.last_kernel = None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        oom = None
        try:
            value, meta = self._wall(point, fidelity=fidelity)
        except torch.OutOfMemoryError as e:
            oom = f"{type(e).__name__}: {str(e)[:500]}"
        if oom is not None:  # the failed point's tensors are free only here
            torch.cuda.empty_cache()
            return -math.inf, {"oom": True, "error": oom}
        meta = dict(meta)
        if flash_attention.last_config is not None:
            meta["attn_config"] = dict(flash_attention.last_config)
            meta["attn_kernel"] = flash_attention.last_kernel
        if on_card:
            meta["peak_bytes"] = int(torch.cuda.max_memory_allocated())
        return value, meta
