"""``k3_roofline``: decode attention (K3, ``kernels/decode_attention.py``)
against its roofline, in percent: the least time of every K3 call of the
window's decode steps (one a layer) over K3's device time in the trace."""
from portbench.readers import kernel_share


def read(run):
    return kernel_share(run, "k3", "decode_kernel", "decode_steps")
