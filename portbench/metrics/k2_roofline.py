"""``k2_roofline``: flash attention (K2, ``kernels/flash_attention.py``)
against its roofline, in percent: the least time of every K2 call of the
window's prefills (one a layer) over K2's device time in the trace."""
from portbench.readers import kernel_share


def read(run):
    return kernel_share(run, "k2", "flash_fwd", "prefill_steps")
