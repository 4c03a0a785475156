"""Model / shape configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeConfig``s.  Configs are plain frozen
dataclasses so they hash, compare, and print cleanly, and so the tuner can
treat "a point in backend-parameter space applied to a config" as a pure
value.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs for architecture families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN settings (GShard-style top-k routing)."""

    num_experts: int
    top_k: int
    d_expert: int  # hidden width of each expert FFN
    every: int = 1  # MoE FFN on layers where (layer_idx % every == every-1)
    capacity_factor: float = 1.25
    num_shared_experts: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective-SSM block (Jamba's SSM layer)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' block (data-dependent decay linear recurrence)."""

    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    gate_lora: int = 0  # 0 => d_model // 2 is typical; we use full proj


# ---------------------------------------------------------------------------
# The main model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 => d_model // num_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA window (h2o-danube)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"  # mlp activation ("silu" -> SwiGLU, "gelu" -> GeGLU-less)
    tie_embeddings: bool = False

    # family extras
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # hybrid interleave: layer i is attention iff i % attn_period == attn_offset,
    # otherwise the SSM mixer. attn_period=0 => all-attention.
    attn_period: int = 0
    attn_offset: int = 0

    # encoder-decoder (whisper): number of encoder layers (decoder = num_layers)
    encoder_layers: int = 0
    encoder_seq_len: int = 0  # stub frontend sequence length (audio frames)

    # vlm stub frontend: number of image tokens whose embeddings arrive
    # precomputed from the (stubbed) vision tower.
    num_frontend_tokens: int = 0

    # embedding/head tables are padded up to a multiple of this so the vocab
    # dim shards over the model axis (e.g. whisper's 51865 -> 52224); padded
    # classes are never targets and standard CE handles them.
    vocab_pad_multiple: int = 256

    # --- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.rwkv is not None and self.attn_period == 0

    @property
    def has_subquadratic_path(self) -> bool:
        """True if the arch can serve 500k-token contexts (bounded state/KV)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def mixer_kind(self, layer_idx: int) -> str:
        """Which sequence mixer layer ``layer_idx`` uses."""
        if self.rwkv is not None:
            return "rwkv"
        if self.mamba is not None:
            if self.attn_period and layer_idx % self.attn_period == self.attn_offset:
                return "mla" if self.mla else "attn"
            return "mamba"
        if self.mla is not None:
            return "mla"
        return "attn"

    def mlp_kind(self, layer_idx: int) -> str:
        if self.moe is not None and layer_idx % self.moe.every == self.moe.every - 1:
            return "moe"
        return "dense"

    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(
            (self.mixer_kind(i), self.mlp_kind(i)) for i in range(self.num_layers)
        )

    def layer_period(self) -> int:
        """Smallest repeating period of the layer plan (for scan-over-periods)."""
        plan = self.layer_plan()
        n = len(plan)
        for p in range(1, n + 1):
            if n % p == 0 and plan == plan[:p] * (n // p):
                return p
        return n

    # --- parameter count (for MODEL_FLOPS = 6 N D) --------------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and per-token-active."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        total = 0
        active = 0
        embed = self.padded_vocab * d
        total += embed + (0 if self.tie_embeddings else embed)
        active += embed + (0 if self.tie_embeddings else embed)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * nh * qk_head
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * nh * (m.qk_nope_head_dim + m.v_head_dim)
                p += nh * m.v_head_dim * d
                return p
            p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if self.qkv_bias:
                p += (nh + 2 * nkv) * hd
            return p

        def mamba_params() -> int:
            mc = self.mamba
            d_in = mc.expand * d
            dtr = mc.resolved_dt_rank(d)
            p = d * 2 * d_in  # in_proj
            p += d_in * mc.d_conv  # depthwise conv
            p += d_in * (dtr + 2 * mc.d_state)  # x_proj
            p += dtr * d_in + d_in  # dt_proj
            p += d_in * mc.d_state + d_in  # A_log, D
            p += d_in * d  # out_proj
            return p

        def rwkv_params() -> int:
            rc = self.rwkv
            p = 4 * d * d  # r, k, v, output projections
            p += d * d  # gate
            p += 2 * (d * rc.decay_lora + rc.decay_lora * d)  # w lora + dt lora
            p += 5 * (d + 2 * d * rc.mix_lora)  # token-shift ddlerp loras
            p += 2 * d  # ln_x params
            return p

        def dense_mlp() -> int:
            return 3 * d * self.d_ff  # SwiGLU: gate, up, down

        def moe_mlp() -> int:
            m = self.moe
            router = d * m.num_experts
            expert = 3 * d * m.d_expert
            return router + m.num_experts * expert, router + m.top_k * expert

        for i in range(self.num_layers):
            mk, fk = self.mixer_kind(i), self.mlp_kind(i)
            mp = {"attn": attn_params, "mla": attn_params, "mamba": mamba_params,
                  "rwkv": rwkv_params}[mk]()
            total += mp + 2 * d
            active += mp + 2 * d
            if fk == "moe":
                t, a = moe_mlp()
                total += t
                active += a
            else:
                total += dense_mlp()
                active += dense_mlp()
        # encoder stack (whisper): attention + cross-attn sized like decoder
        if self.encoder_layers:
            enc_layer = attn_params() + dense_mlp() + 2 * d
            cross = self.num_layers * (attn_params() + d)
            total += self.encoder_layers * enc_layer + cross
            active += self.encoder_layers * enc_layer + cross
        total += d  # final norm
        active += d
        return {"total": int(total), "active": int(active)}

    # --- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config: same layer plan structure, small dims."""
        period = self.layer_period()
        n_layers = max(period, min(self.num_layers, 2 * period))
        kw = dict(
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            vocab_pad_multiple=1,
            head_dim=16,
            encoder_seq_len=16 if self.encoder_layers else 0,
            encoder_layers=min(self.encoder_layers, 2),
            num_frontend_tokens=min(self.num_frontend_tokens, 4),
            sliding_window=8 if self.sliding_window else None,
        )
        if self.moe:
            kw["moe"] = MoEConfig(
                num_experts=4, top_k=min(self.moe.top_k, 2), d_expert=32,
                every=self.moe.every, capacity_factor=self.moe.capacity_factor,
            )
        if self.mla:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.mamba:
            kw["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8)
        if self.rwkv:
            kw["rwkv"] = RWKVConfig(head_size=16, decay_lora=8, mix_lora=8)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs; reason string if skipped."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_path:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
