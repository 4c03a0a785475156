"""``decode_step_ms``: the mean device time of a decode step in the window,
from the CUDA events the driver records around each call of the program's
compiled decode step (span ``decode``)."""
from portbench.readers import mean_span


def read(run):
    return mean_span(run, "decode")
