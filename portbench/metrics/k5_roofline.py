"""``k5_roofline``: the RWKV-6 scan (K5, ``kernels/gla_scan.py``) against its
roofline, in percent: the least time of every K5 call of the window's
train steps (one a layer, forward) over K5's device time in the trace."""
from portbench.readers import kernel_share


def read(run):
    return kernel_share(run, "k5", "gla_kernel", "train_steps")
