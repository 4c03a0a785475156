"""Unified decoder-only LM covering the dense / MoE / hybrid / SSM / VLM
families (four mixers: attention, MLA, Mamba, RWKV-6; three MLP kinds:
dense, MoE, RWKV's channel mix).

Layer stacks follow the *repeating period* of the layer plan
(configs/base.py:layer_period): per-period-position parameters are stacked
along a leading ``layers`` dim, as in the reference package, and walked
with a python loop (eager PyTorch has no scan to compile).

Training (``mode="full"`` with grad enabled) wraps each period in
``torch.utils.checkpoint`` as ``rt.remat`` asks, as the reference wraps its
scanned period function in ``jax.checkpoint``: ``none`` saves everything,
``full`` recomputes the whole period, ``dots`` saves the outputs of the
matrix products (``aten.mm`` / ``bmm`` / ``addmm``) and recomputes the rest,
``names`` saves only ``mixer_out`` and ``mlp_out``, the two points that
``checkpoint_name`` marks.  The kernels' forwards run inside the period
and so run again in its recompute.

Three entry points: ``forward`` (full / prefill), ``decode_step`` and
``init_cache``.  The cache is updated in place and handed back;
``cache["pos"]`` is a host integer.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import P, dense_init, stack_layer_params, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.models.layers import shard_hint

MIXER_INIT = {
    "attn": L.init_attention,
    "mla": L.init_mla,
    "mamba": L.init_mamba,
    "rwkv": L.init_rwkv_tmix,
}


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that the dispatcher sees, so that a selective-checkpoint
    policy can save its output (``jax.ad_checkpoint.checkpoint_name``).  A
    custom op may not return its input, hence the copy."""
    return x.clone()


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def checkpoint_name(x: torch.Tensor, name: str, mark: bool) -> torch.Tensor:
    """Mark ``x`` as the residual ``name`` where ``mark`` is set (the period
    runs under the ``names`` policy, the only one that looks for the mark);
    else ``x`` itself, with no copy."""
    return _checkpoint_name(x, name) if mark else x


#: what each selective remat mode saves (everything else is recomputed)
_SAVED_OPS = {
    "dots": [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default],
    "names": [torch.ops.repro_torch.checkpoint_name.default],
}


def _remat(fn, mode: str, *args):
    """``fn(*args)`` under the remat policy ``mode`` (not ``none``)."""
    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    ctx = functools.partial(create_selective_checkpoint_contexts, _SAVED_OPS[mode])
    return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)


def _init_block(gen, cfg: ModelConfig, mixer_kind: str, mlp_kind: str) -> dict:
    block = {
        "norm1": L.init_rmsnorm(cfg.d_model, device=gen.device),
        "mixer": MIXER_INIT[mixer_kind](gen, cfg),
        "norm2": L.init_rmsnorm(cfg.d_model, device=gen.device),
    }
    if cfg.rwkv is not None:
        block["mlp"] = L.init_rwkv_cmix(gen, cfg)
    elif mlp_kind == "moe":
        block["mlp"] = L.init_moe(gen, cfg)
    else:
        block["mlp"] = L.init_mlp(gen, cfg)
    return block


def cast_tree(tree, dtype):
    """The P-tree with every floating leaf cast to ``dtype`` (None: as is)."""
    if dtype is None:
        return tree
    return tree_map(lambda p: P(p.value.to(dtype) if p.value.is_floating_point()
                                else p.value, p.axes), tree)


def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    """Returns a P-tree (values + logical axes), on the generator's device.
    Same tree structure, shapes and distributions as the reference package;
    the random numbers themselves differ.  Drawn in f32; ``dtype`` casts
    each block as soon as it is drawn, so the f32 copy of the whole model
    never exists (a period of Jamba is 53 GB in f32)."""
    plan = cfg.layer_plan()
    period = cfg.layer_period()
    n_periods = cfg.num_layers // period

    params = cast_tree({
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                            ("vocab", "embed"), fan_in=cfg.d_model),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=gen.device),
    }, dtype)
    if not cfg.tie_embeddings:
        params["head"] = cast_tree(dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                              ("embed", "vocab"), fan_in=cfg.d_model), dtype)

    blocks = {}
    for pos in range(period):
        mixer_kind, mlp_kind = plan[pos]
        per_period = [
            cast_tree(_init_block(gen, cfg, mixer_kind, mlp_kind), dtype)
            for _ in range(n_periods)
        ]
        blocks[f"pos{pos}"] = stack_layer_params(per_period)
        del per_period  # the stack is a copy: free the drawn blocks now
    params["blocks"] = blocks
    return params


def _block_apply(
    block, x, *, cfg: ModelConfig, rt: Runtime, mixer_kind: str, mlp_kind: str,
    mode: str, cache: Optional[dict], pos: Optional[int], mark: bool = False,
) -> Tuple[torch.Tensor, float, Optional[dict]]:
    """Pre-norm residual block.  Returns (x, aux_loss, new_cache).  ``mark``
    marks ``mixer_out`` and ``mlp_out`` for the ``names`` remat policy."""
    use_rope = cfg.attn_period == 0  # hybrids carry no explicit PE
    h = L.rmsnorm(block["norm1"], x, cfg.norm_eps, rt)
    mixer_cache = cache.get("mixer") if cache else None
    new_cache = {}
    if mixer_kind == "attn":
        h, mc = L.attention_apply(block["mixer"], h, cfg=cfg, rt=rt, mode=mode,
                                  cache=mixer_cache, pos=pos, use_rope=use_rope)
    elif mixer_kind == "mla":
        h, mc = L.mla_apply(block["mixer"], h, cfg=cfg, rt=rt, mode=mode,
                            cache=mixer_cache, pos=pos)
    elif mixer_kind == "mamba":
        h, mc = L.mamba_apply(block["mixer"], h, cfg=cfg, rt=rt, mode=mode,
                              cache=mixer_cache, pos=pos)
    elif mixer_kind == "rwkv":
        h, mc = L.rwkv_tmix_apply(block["mixer"], h, cfg=cfg, rt=rt, mode=mode,
                                  cache=mixer_cache)
    else:
        raise ValueError(mixer_kind)
    x = x + checkpoint_name(h, "mixer_out", mark)
    if mc is not None:
        new_cache["mixer"] = mc

    h = L.rmsnorm(block["norm2"], x, cfg.norm_eps, rt)
    aux = 0.0
    if cfg.rwkv is not None:
        h, cc = L.rwkv_cmix_apply(block["mlp"], h, cfg=cfg, rt=rt, mode=mode,
                                  cache=cache.get("mlp") if cache else None)
        if cc is not None:
            new_cache["mlp"] = cc
    elif mlp_kind == "moe":
        h, aux = L.moe_apply(block["mlp"], h, cfg=cfg, rt=rt)
    else:
        h = L.mlp_apply(block["mlp"], h, cfg=cfg, rt=rt)
    x = x + checkpoint_name(h, "mlp_out", mark)
    return x, aux, (new_cache or None)


def _embed(params, tokens, cfg, rt, image_embeds=None):
    x = F.embedding(tokens, params["embed"]).to(rt.dtype())
    if image_embeds is not None:
        n = image_embeds.shape[1]
        x = torch.cat([image_embeds.to(x.dtype), x[:, n:]], dim=1)
    return shard_hint(x, ("batch", None, "embed_act"))


def _head(params, x, cfg, rt):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, rt)
    w = params.get("head")
    if w is None:
        w = params["embed"].T
    logits = x.to(rt.dtype()) @ w.to(rt.dtype())
    return shard_hint(logits, ("batch", None, "vocab"))


def _walk_periods(params, cache_layers, x, *, cfg, rt, mode, pos):
    """Apply every layer in order: period by period, position by position.
    A stacked param leaf is unbound once (its gradient is then one stack of
    the layers' gradients, not one full-size scatter a layer); ``a[i]`` of
    a stacked cache leaf is a view, so the cache slices handed to the
    blocks alias the stacked cache and are updated in place."""
    plan = cfg.layer_plan()
    period = cfg.layer_period()
    n_periods = cfg.num_layers // period
    layers = {key: tree_map(lambda a: a.unbind(0), blocks)
              for key, blocks in params["blocks"].items()}
    # training only: serving runs under no_grad and ignores remat
    remat = rt.remat != "none" and mode == "full" and torch.is_grad_enabled()
    mark = remat and rt.remat == "names"

    def period_fn(x, i):
        aux = 0.0
        for pos_i in range(period):
            mixer_kind, mlp_kind = plan[pos_i]
            key = f"pos{pos_i}"
            block = tree_map(lambda a: a[i], layers[key])
            c = (tree_map(lambda a: a[i], cache_layers[key])
                 if cache_layers else None)
            x, aux_i, _ = _block_apply(
                block, x, cfg=cfg, rt=rt, mixer_kind=mixer_kind,
                mlp_kind=mlp_kind, mode=mode, cache=c, pos=pos, mark=mark,
            )
            aux = aux + aux_i
        return x, aux

    aux = 0.0
    for i in range(n_periods):
        x, aux_i = _remat(period_fn, rt.remat, x, i) if remat else period_fn(x, i)
        aux = aux + aux_i
    return x, aux


def forward(
    params,
    tokens: torch.Tensor,  # (B, S) integer
    *,
    cfg: ModelConfig,
    rt: Runtime,
    mode: str = "full",  # full | prefill
    cache: Optional[dict] = None,
    image_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (logits, aux_loss, new_cache).

    mode="full":    logits for every position.
    mode="prefill": logits for the LAST position only + the cache, filled
                    in place.
    """
    if mode not in ("full", "prefill"):
        raise ValueError(f"forward mode must be 'full' or 'prefill', got {mode!r}")
    if mode == "prefill" and cache is None:
        raise ValueError("mode='prefill' needs a cache (Model.init_cache)")
    x = _embed(params, tokens, cfg, rt, image_embeds)
    cache_layers = cache["layers"] if (cache is not None and mode == "prefill") else None
    x, aux = _walk_periods(params, cache_layers, x, cfg=cfg, rt=rt, mode=mode, pos=None)

    new_cache = None
    if mode == "prefill":
        new_cache = {"pos": int(tokens.shape[1]), "layers": cache_layers}
        x = x[:, -1:]  # only last-position logits for prefill
    logits = _head(params, x, cfg, rt)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    return logits, aux, new_cache


def decode_step(
    params,
    tokens: torch.Tensor,  # (B, 1) integer
    cache: dict,
    *,
    cfg: ModelConfig,
    rt: Runtime,
) -> Tuple[torch.Tensor, dict]:
    """One decode token for the whole batch.  Returns (logits (B,1,V), cache);
    the cache is the one passed in, updated in place, with ``pos`` advanced."""
    pos = int(cache["pos"])
    x = _embed(params, tokens, cfg, rt)
    x, _ = _walk_periods(params, cache["layers"], x, cfg=cfg, rt=rt,
                         mode="decode", pos=pos)
    logits = _head(params, x, cfg, rt)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


# ---------------------------------------------------------------------------
# Cache construction (P-tree, like params)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    plan = cfg.layer_plan()
    period = cfg.layer_period()
    n_periods = cfg.num_layers // period

    def cache_for(mixer_kind):
        if mixer_kind == "attn":
            return {"mixer": L.init_attention_cache(cfg, batch, cache_len, device=device)}
        if mixer_kind == "mla":
            return {"mixer": L.init_mla_cache(cfg, batch, cache_len, device=device)}
        if mixer_kind == "mamba":
            return {"mixer": L.init_mamba_cache(cfg, batch, device=device)}
        rc = L.init_rwkv_cache(cfg, batch, device=device)
        return {"mixer": {"x_tmix": rc["x_tmix"], "S": rc["S"]},
                "mlp": {"x_cmix": rc["x_cmix"]}}

    layer_caches = {}
    for pos_i in range(period):
        mixer_kind, _ = plan[pos_i]
        per = [cache_for(mixer_kind) for _ in range(n_periods)]
        layer_caches[f"pos{pos_i}"] = stack_layer_params(per)
    return {"pos": P(0, ()), "layers": layer_caches}
