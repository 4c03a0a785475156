"""``k5_roofline.prefill``: K5 in the served prefill against its roofline, in
percent: the least time of every state-writing K5 call of the window's
prefills (one a layer a wave; ``portbench/roofline_served.py``, over the
prompts' own tokens) over the device time of the kernels named
``gla_state_kernel`` in the trace.  Its launches are checked against the
program's counter ``gla_scan_state``; a program without that kernel
(nothing of that name in the trace) reads nothing."""
from portbench.roofline_served import k5_state_seconds

NAME_PART = "gla_state_kernel"
COUNTER = "gla_scan_state"


def read(run):
    if run.tracing is None:
        return None
    seconds, launches = run.tracing.kernel(NAME_PART)
    work = run.work.get("prefill_steps", [])
    if not launches or not work or not run.conf.get("port", {}).get("rwkv"):
        return None
    port, dtype = run.conf["port"], run.conf["dtype"]
    calls = port["num_layers"] * len(work)
    counted = run.counters.get(COUNTER)
    if launches != calls or counted != calls:
        run.notes.append(f"k5 prefill: {launches} launches named {NAME_PART!r} in the trace, "
                         f"{counted} counted by the program, {calls} calls in the window's "
                         "prefills")
    least = sum(k5_state_seconds(port, dtype, *shape) for shape in work) * port["num_layers"]
    return 100.0 * least / seconds
