"""The tunable backend-parameter space — the paper's Table 1 analogue.

| paper (TF Intel-CPU backend)      | here (the reference's mesh / one card) |
|-----------------------------------|----------------------------------------|
| inter_op_parallelism_threads      | log2_dp  (data-parallel mesh degree)   |
| intra_op / OMP_NUM_THREADS        | tp = chips / dp (cooperating chips)    |
| OMP backend parallelism           | sharding_style: tp vs fsdp_tp (ZeRO)   |
| KMP_BLOCKTIME                     | block_q/block_kv kernel tiles, remat   |
| batch_size                        | microbatches (+ moe capacity factor)   |

``BackendConfig`` is the point the gradient-free engines move through;
``backend_space`` builds the per-arch search space (attention-free archs
drop the attention-tile dims, like the paper's per-model batch ranges).

The mesh dims depend on the pod: ``dp``, ``tp`` and ``backend_space`` take
``chips_per_pod`` (the reference's 256 by default).  On one card
(``chips_per_pod=1``) dp = tp = 1 whatever ``log2_dp`` and
``sharding_style`` say, so the space leaves both out: a dimension that
tunes nothing only spends budget (``config_from_point``'s reasoning).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.models.runtime import REMAT_MODES, Runtime


@dataclass(frozen=True)
class BackendConfig:
    log2_dp: int = 4  # dp = 2**log2_dp; tp = chips_per_pod / dp
    sharding_style: str = "fsdp_tp"  # tp | fsdp_tp
    microbatches: int = 1
    remat: str = "full"  # none | dots | names | full
    block_q: int = 512
    block_kv: int = 512
    scan_chunk: int = 128
    capacity_factor: float = 0.0  # 0 => config default
    opt_state_dtype: str = "f32"  # f32 | bf16
    factored_opt: bool = False
    attn_impl: str = "chunked"  # the dry run traces the chunked oracle path
    compute_dtype: str = "bf16"
    unroll_layers: bool = False
    attn_prune: bool = False  # beyond-paper: causal tile skipping
    serve_bf16_params: bool = False  # beyond-paper: bf16 serving weights
    moe_impl: str = "gspmd"  # beyond-paper alt: ep_local (expert parallel)
    cache_shard: str = "seq"  # decode KV-cache shard dim: seq | heads

    def __post_init__(self):
        # same validated vocabulary as Runtime — reject at construction,
        # where the bad value's origin is still in the traceback
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"unknown remat mode {self.remat!r}; one of {REMAT_MODES}")

    def runtime(self) -> Runtime:
        return Runtime(
            attn_impl=self.attn_impl,
            scan_impl="chunked",
            block_q=self.block_q,
            block_kv=self.block_kv,
            scan_chunk=self.scan_chunk,
            remat=self.remat,
            compute_dtype=self.compute_dtype,
            moe_capacity_factor=self.capacity_factor,
            moe_impl=self.moe_impl,
            unroll_layers=self.unroll_layers,
            attn_prune=self.attn_prune,
        )

    def dp(self, chips_per_pod: int = 256) -> int:
        return min(2 ** self.log2_dp, chips_per_pod)

    def tp(self, chips_per_pod: int = 256) -> int:
        return chips_per_pod // self.dp(chips_per_pod)

    def replace(self, **kw) -> "BackendConfig":
        return dataclasses.replace(self, **kw)


# paper-faithful default: the configuration a savvy user would start from
BASELINE = BackendConfig()

_REMAT = REMAT_MODES  # single source of truth: repro_torch.models.runtime
_STYLES = ("tp", "fsdp_tp")


def backend_space(cfg: ModelConfig, *, kind: str = "train",
                  chips_per_pod: int = 256) -> "list[dict]":
    """Search-space description consumed by core.space.SearchSpace.

    Returns a list of dim dicts: {"name", "type": int|cat, "min","max","step"}
    or {"name","type":"cat","choices":[...]}.  The mesh dims span the pod
    (``log2_dp`` up to log2 of ``chips_per_pod``) and are left out on one
    card, where they would tune nothing.
    """
    dims = []
    if chips_per_pod > 1:
        dims += [
            {"name": "log2_dp", "type": "int", "min": 0,
             "max": int(math.log2(chips_per_pod)), "step": 1},
            {"name": "sharding_style", "type": "cat", "choices": list(_STYLES)},
        ]
    if kind == "train":
        dims += [
            {"name": "microbatches", "type": "cat", "choices": [1, 2, 4, 8, 16]},
            {"name": "remat", "type": "cat", "choices": list(_REMAT)},
        ]
    if not cfg.is_attention_free:
        dims += [
            {"name": "block_q", "type": "int", "min": 128, "max": 1024, "step": 128},
            {"name": "block_kv", "type": "int", "min": 128, "max": 1024, "step": 128},
        ]
    if cfg.mamba is not None or cfg.rwkv is not None:
        dims += [
            {"name": "scan_chunk", "type": "int", "min": 32, "max": 256, "step": 32},
        ]
    if cfg.moe is not None:
        dims += [
            {"name": "capacity_factor", "type": "cat",
             "choices": [1.0, 1.25, 1.5, 2.0]},
        ]
    return dims


def config_from_point(point: dict, base: BackendConfig = BASELINE,
                      *, allow_extra: "tuple | frozenset" = (),
                      ) -> BackendConfig:
    """Instantiate a BackendConfig from a tuner point (dict of dim values).

    Point keys that are not ``BackendConfig`` fields raise ``ValueError``:
    silently dropping them meant a typo'd search-space dim (``blok_q``)
    tuned nothing while the search happily burned budget varying it.
    ``allow_extra`` names keys a caller *knowingly* handles outside
    ``BackendConfig`` (e.g. host-level knobs applied by a harness) —
    those are skipped, everything else unknown is an error.
    """
    fields = {f.name for f in dataclasses.fields(BackendConfig)}
    extra = frozenset(allow_extra)
    stray = sorted(k for k in point if k not in fields and k not in extra)
    if stray:
        raise ValueError(
            f"point keys {stray} are not BackendConfig fields "
            f"(known: {sorted(fields)}); a misspelled search-space dim "
            "would otherwise tune nothing — fix the dim name, or pass "
            "allow_extra= for keys genuinely handled elsewhere")
    kw = {k: v for k, v in point.items() if k in fields}
    return dataclasses.replace(base, **kw)
