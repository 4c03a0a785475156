"""``train_backward_ms``: the mean device time of the compiled train step's
backward phase in the window's replays, in ms: ``autograd.grad`` of the
loss (the oracles' recompute included), timed by the pair of events the
program captures into the step's graph around it (span ``train.backward``
of ``train/train_step.py``), summed over the microbatches."""
from portbench.port_spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "train.backward", "train")
