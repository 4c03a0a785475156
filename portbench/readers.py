"""What the per-layer readers share (each reader is a file of its own under
``metrics/``).  A reader returns None where its run holds nothing for it to
read: no span of its kind, or no launch of its kernel in the trace."""
from __future__ import annotations

from portbench import roofline


def mean_span(run, kind: str):
    ms = run.span_ms(kind)
    return sum(ms) / len(ms) if ms else None


def _attn(port):
    H, K = port["num_heads"], port["num_kv_heads"]
    return H, K, port.get("head_dim") or port["d_model"] // H


def step_share(run, kind: str):
    """The ``kind`` steps' least time over their measured time, in percent."""
    ms = run.span_ms(kind)
    work = run.work.get(f"{kind}_steps", [])
    if not ms or len(ms) != len(work):
        return None
    port, dtype = run.conf["port"], run.conf["dtype"]
    fn = {"decode": roofline.decode_step, "prefill": roofline.prefill_step,
          "train": roofline.train_step}[kind]
    least = sum(roofline.least_seconds(*fn(port, dtype, *shape), dtype) for shape in work)
    return 100.0 * least / (sum(ms) / 1e3)


def _call(kernel: str, port: dict, dtype: str, shape):
    B, n = shape
    if kernel == "k3":
        H, K, dh = _attn(port)
        return roofline.k3_call(B, H, K, dh, n, dtype)
    if kernel == "k2":
        H, K, dh = _attn(port)
        return roofline.k2_call(B, n, H, K, dh, dtype)
    hs = port["rwkv"]["head_size"]
    return roofline.k5_call(B, n, port["d_model"] // hs, hs, hs, dtype)


#: the program's launch counter (``runtime/graphs.py::kernel_counters``) of each kernel
COUNTER = {"k2": "flash_attention", "k3": "decode_attention", "k5": "gla_scan"}


def kernel_share(run, kernel: str, name_part: str, work_key: str):
    """Kernel ``kernel``'s least time over the window's calls (one a layer
    a step of ``work_key``) over its device time in the trace, in percent."""
    if run.tracing is None:
        return None
    seconds, launches = run.tracing.kernel(name_part)
    work = run.work.get(work_key, [])
    if not launches or not work:
        return None
    port, dtype = run.conf["port"], run.conf["dtype"]
    calls = port["num_layers"] * len(work)
    counted = run.counters.get(COUNTER[kernel])
    if launches != calls or counted != calls:
        run.notes.append(f"{kernel}: {launches} launches named {name_part!r} in the trace, "
                         f"{counted} counted by the program, {calls} calls in the window's steps")
    least = sum(roofline.least_seconds(*_call(kernel, port, dtype, s), dtype)
                for s in work) * port["num_layers"]
    return 100.0 * least / seconds
