"""The benchmark's cells shrunk to a size the CPU runs in seconds: the same
drivers, traffic generator, references and checks, at a few layers of
width 64 and a handful of tokens."""
from __future__ import annotations

import copy

TINY_PORT = {"num_layers": 2, "d_model": 64, "num_heads": 4, "d_ff": 128, "vocab_size": 256,
             "head_dim": 16}
TINY_TRAFFIC = {
    "decode_sessions": {"sessions": 3, "context": 20, "cache_len": 32, "gen": 6},
    "serve_waves": {"batch": 3, "prompt_min": 4, "prompt_max": 12, "pad_to": 12, "gen": 5},
    "train_steps": {"batch": 2, "seq": 24},
}


def shrink(workload: dict) -> dict:
    """``workload`` (as ``spec.workload`` gives it) at the tiny size."""
    w = copy.deepcopy(workload)
    port = w["config_file"]["port"]
    port.update(TINY_PORT)
    port["num_kv_heads"] = 2 if not port.get("rwkv") else 4
    if port.get("rwkv"):
        port["rwkv"] = dict(port["rwkv"], head_size=16, decay_lora=8, mix_lora=8)
    cell = w["cell"]
    cell["traffic"].update(TINY_TRAFFIC[cell["driver"]])
    if "sample" in cell:
        cell["sample"] = 2
    return w
