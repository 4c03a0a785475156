"""Three-term roofline for one NVIDIA H100 SXM (the reference's model for
a TPU v5e pod, with the card's constants).

    compute_term    = FLOPs_per_device / peak_FLOPs            [s]
    memory_term     = bytes_per_device / HBM_bw                [s]
    collective_term = collective_bytes_per_device / link_bw    [s]

est_step_time = max of the three; throughput = tokens / est.

The constants are the data sheet's, not a measurement, so that an
analysis does not depend on the run that made it; ``chip_smoke.py`` phase
``roofline`` measures the card's copy and matmul rates beside them.
``Roofline`` takes its constants as ``hw`` so that another chip's figures
can be given to it.

The analytic traffic model (``analytic_hbm_traffic``) stays the
reference's fused-kernel model: every materialised tensor written once and
read once.  It is the headline memory term; the port's own eager traffic
(``tuning/trace_analysis.py``) is reported beside it.  Unlike the
reference, the analytic functions take dp and tp from the mesh the cell is
analysed on: the reference reads them at a 256-chip pod whatever the mesh
(``bc.dp()`` / ``bc.tp()`` at their default), which on one card reckons a
256-way tensor-parallel split.  At a pod of 256 chips the two agree number
for number.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Hardware:
    """Per-chip peak rates and memory."""

    name: str
    peak_flops: float  # dense bf16 FLOP/s
    hbm_bw: float  # B/s
    link_bw: float  # B/s, one direction
    hbm_bytes: float


#: NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 (tensor cores, no
#: sparsity), 3.35 TB/s HBM3, 80 GB HBM3, NVLink 4 at 900 GB/s both
#: directions together (450 GB/s a direction)
H100_SXM = Hardware("NVIDIA H100 SXM", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9, hbm_bytes=80e9)

PEAK_FLOPS_BF16 = H100_SXM.peak_flops  # FLOP/s
HBM_BW = H100_SXM.hbm_bw  # B/s
NVLINK_BW = H100_SXM.link_bw  # B/s a direction
HBM_BYTES = H100_SXM.hbm_bytes  # HBM capacity

# collective traffic multipliers (ring algorithms, per-device result bytes)
_KIND_FACTOR = {
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float  # kernel-adjusted HBM traffic (headline term)
    collective_bytes: float  # per device, kind-weighted
    tokens_per_step: float
    chips: int
    model_flops: float = 0.0  # analytic 6*N*D (train) / 2*N*D (serve), global
    memory_per_device: Optional[float] = None
    collective_detail: str = ""
    bytes_hlo_raw: float = 0.0  # every traced op's bytes, kernel regions included
    bytes_kernel_credit: float = 0.0  # analytic kernel traffic added back
    hw: Hardware = H100_SXM

    @property
    def compute_term(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_term(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_term(self) -> float:
        return self.collective_bytes / self.hw.link_bw

    @property
    def terms(self) -> Dict[str, float]:
        return {
            "compute": self.compute_term,
            "memory": self.memory_term,
            "collective": self.collective_term,
        }

    @property
    def bottleneck(self) -> str:
        t = self.terms
        return max(t, key=t.get)

    @property
    def est_step_time(self) -> float:
        return max(self.terms.values())

    @property
    def throughput(self) -> float:
        """tokens/s at the roofline estimate."""
        t = self.est_step_time
        return self.tokens_per_step / t if t > 0 else float("inf")

    @property
    def roofline_fraction(self) -> float:
        """What fraction of the step is pinned to the compute roof —
        1.0 means perfectly compute-bound (the ceiling)."""
        t = self.est_step_time
        return self.compute_term / t if t > 0 else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the estimated step time."""
        t = self.est_step_time
        if t <= 0 or not self.model_flops:
            return 0.0
        return self.model_flops / (t * self.chips * self.hw.peak_flops)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global traced FLOPs — catches remat/redundancy waste."""
        traced_global = self.flops_per_device * self.chips
        return self.model_flops / traced_global if traced_global else 0.0

    @property
    def fits_hbm(self) -> Optional[bool]:
        if self.memory_per_device is None:
            return None
        return self.memory_per_device <= self.hw.hbm_bytes

    def row(self) -> Dict[str, object]:
        return {
            "compute_s": self.compute_term,
            "memory_s": self.memory_term,
            "collective_s": self.collective_term,
            "bottleneck": self.bottleneck,
            "est_step_s": self.est_step_time,
            "throughput_tok_s": self.throughput,
            "roofline_fraction": self.roofline_fraction,
            "mfu": self.mfu,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mem_per_device_GB": (self.memory_per_device or 0) / 1e9,
            "fits_hbm": self.fits_hbm,
            "collectives": self.collective_detail,
            "memory_s_hlo_raw": self.bytes_hlo_raw / self.hw.hbm_bw,
            "kernel_credit_GB": self.bytes_kernel_credit / 1e9,
        }


def weighted_collective_bytes(bytes_by_kind: Dict[str, int]) -> float:
    return float(sum(_KIND_FACTOR.get(k, 1.0) * v for k, v in bytes_by_kind.items()))


def _split(bc, chips: int, chips_per_pod: Optional[int]):
    """(batch shards over every pod, tensor-parallel ways) of ``chips``
    chips in pods of ``chips_per_pod`` (default: ``chips`` up to the
    reference's pod of 256)."""
    cpp = chips_per_pod or min(chips, 256)
    pods = max(1, chips // cpp)
    return bc.dp(cpp) * pods, bc.tp(cpp)


def kernel_traffic_bytes(cfg, shape, bc, chips: int,
                         chips_per_pod: Optional[int] = None) -> float:
    """Analytic per-device HBM traffic of the kernelised regions (flash
    attention / decode attention / ssm / gla scans): what the kernels
    actually move — Q/O once, K/V streamed once per query block, scan
    inputs/outputs once; softmax/scan state stays on chip.

    Training multiplies by ~4 (fwd + remat replay + bwd reads/writes);
    prefill/decode by 1.  This credit replaces the traced op-chain traffic
    of the tagged ``krnl_`` regions (trace_analysis)."""
    dp_total, tp = _split(bc, chips, chips_per_pod)
    B_dev = max(1, shape.global_batch // min(dp_total, shape.global_batch))
    bpe = 2  # bf16
    train_factor = 4.0 if shape.kind == "train" else 1.0

    def shard(n: int, ways: int) -> float:
        return n / ways if n % ways == 0 else n  # divisibility rule

    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    H_dev = shard(H, tp)
    total = 0.0
    for i in range(cfg.num_layers):
        mk = cfg.mixer_kind(i)
        if mk in ("attn", "mla"):
            if shape.kind == "decode":
                # KV cache read once per token; cache seq shards over tp
                Skv = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
                Skv_dev = shard(Skv, tp)
                if mk == "mla":
                    row = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                    total += B_dev * Skv_dev * row * bpe
                else:
                    total += 2 * B_dev * Skv_dev * K * dh * bpe
                total += 2 * B_dev * H_dev * dh * bpe  # q + out
            else:
                S = shape.seq_len
                nq = max(1, -(-S // bc.block_q))
                qo = 2 * B_dev * S * H_dev * dh * bpe
                if mk == "mla":  # expanded k/v per head in parallel modes
                    kv = 2 * B_dev * S * H_dev * max(dh, cfg.mla.v_head_dim) * bpe
                else:
                    kv = 2 * B_dev * S * shard(K, tp) * dh * bpe
                total += (qo + nq * kv) * train_factor
        elif mk == "mamba":
            d_in = cfg.mamba.expand * cfg.d_model
            d_dev = shard(d_in, tp)
            S = 1 if shape.kind == "decode" else shape.seq_len
            n = cfg.mamba.d_state
            # x, dt, y over d_dev + B, C over d_state, in/out once
            total += (3 * B_dev * S * d_dev + 2 * B_dev * S * n) * bpe * train_factor
        elif mk == "rwkv":
            S = 1 if shape.kind == "decode" else shape.seq_len
            D = cfg.d_model
            total += 5 * B_dev * S * D * bpe * train_factor  # r,k,v,w in; y out
    return float(total)


def analytic_hbm_traffic(cfg, shape, bc, chips: int,
                         chips_per_pod: Optional[int] = None) -> Dict[str, float]:
    """Per-device, per-step HBM traffic under fused kernels (the
    "ideal-fused" memory term).

    Model: every materialized tensor is written once and read once by its
    consumer kernel; elementwise chains fuse; the kernelised regions
    contribute their analytic stream traffic (kernel_traffic_bytes).
    Components:
      * params+optimizer — fwd/bwd weight reads, grad write/read, Adam m/v
        read+write, param update (train); one weight read (serve)
      * activations      — per-layer matmul inputs/outputs + norms +
        residuals (+ MoE dispatch/combine buffers), x4 for train
        (fwd + remat replay + ~2x bwd), x1 otherwise
      * logits/CE        — fp32 logits write+read + bwd
      * kernels          — attention/scan streams (kernel_traffic_bytes)
      * carry stack      — remat-saved per-layer residual write+read (train)
    """
    dp_total, tp = _split(bc, chips, chips_per_pod)
    B_dev = max(1, shape.global_batch // min(dp_total, shape.global_batch))
    S = 1 if shape.kind == "decode" else shape.seq_len
    D = cfg.d_model
    bpe = 2.0
    train = shape.kind == "train"
    act_factor = 4.0 if train else 1.0

    def shard(n: int, ways: int) -> float:
        return n / ways if n % ways == 0 else n

    # --- params + optimizer ---
    p_total = cfg.param_counts()["total"]
    p_dev = p_total / chips  # fsdp_tp shards essentially everything
    if bc.sharding_style == "tp":
        p_dev = p_total / tp
    if train:
        opt_bpe = 2 if bc.opt_state_dtype == "bf16" else 4
        # w read fwd + read bwd (4+4, f32 master) + grad write+read (4+4)
        # + m,v read+write (4*opt_bpe) + p write (4)
        params_bytes = p_dev * (4 + 4 + 4 + 4 + 4 * opt_bpe + 4)
    else:
        params_bytes = p_dev * 4  # f32 weights read once per step (baseline)

    # --- per-layer activations ---
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    H_dev, K_dev = shard(H, tp), shard(K, tp)
    act = 0.0
    for i in range(cfg.num_layers):
        mk, fk = cfg.mixer_kind(i), cfg.mlp_kind(i)
        bsd = B_dev * S * D * bpe
        layer = 4 * bsd  # 2 norms + 2 residual adds (read+write fused pairs)
        if mk in ("attn", "mla"):
            qkv_out = B_dev * S * (H_dev + 2 * K_dev) * dh * bpe
            layer += bsd + qkv_out  # qkv proj in/out
            layer += B_dev * S * H_dev * dh * bpe + bsd  # out proj in/out
        elif mk == "mamba":
            d_in = shard(cfg.mamba.expand * D, tp)
            layer += bsd + 2 * B_dev * S * d_in * bpe  # in_proj
            layer += 2 * B_dev * S * d_in * bpe + bsd  # gate+out_proj
        elif mk == "rwkv":
            layer += 5 * bsd + 2 * bsd  # r,k,v,g,w projections + out
        if cfg.rwkv is not None:
            ff = shard(cfg.d_ff, tp)
            layer += 2 * bsd + 3 * B_dev * S * ff * bpe
        elif fk == "moe":
            m = cfg.moe
            cf = bc.capacity_factor or m.capacity_factor
            tokens_dev = B_dev * S * m.top_k * cf
            ff = m.d_expert if m.num_experts % tp == 0 else shard(m.d_expert, tp)
            layer += B_dev * S * m.num_experts * 4  # router logits
            layer += 2 * tokens_dev * D * bpe * 2  # dispatch + combine buffers
            layer += tokens_dev * (2 * D + 3 * ff) * bpe  # expert mlp streams
        else:
            ff = shard(cfg.d_ff, tp)
            layer += 2 * bsd + 3 * B_dev * S * ff * bpe
        act += layer
    act *= act_factor
    if train:  # remat carry stack: save + re-read layer inputs
        act += 2 * cfg.num_layers * B_dev * shape.seq_len * D * bpe

    # --- logits / CE ---
    V_dev = shard(cfg.padded_vocab, tp)
    S_logit = shape.seq_len if shape.kind == "train" else 1
    logits = B_dev * S_logit * V_dev * (4 + 4)  # f32 write + read
    if train:
        logits *= 2  # bwd pass over logits

    kernels = kernel_traffic_bytes(cfg, shape, bc, chips, chips_per_pod)
    total = params_bytes + act + logits + kernels
    return {
        "params": float(params_bytes),
        "activations": float(act),
        "logits": float(logits),
        "kernels": float(kernels),
        "total": float(total),
    }


def model_flops(cfg, shape, n_active_params: int) -> float:
    """Analytic MODEL_FLOPS per step: 6*N*D train, 2*N*D inference."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active_params * tokens


def tokens_per_step(shape) -> float:
    if shape.kind == "decode":
        return float(shape.global_batch)
    return float(shape.global_batch * shape.seq_len)
