"""``prefill_step_ms``: the mean device time of a prefill step in the window,
from the CUDA events the driver records around each call of the program's
compiled prefill step (span ``prefill``)."""
from portbench.readers import mean_span


def read(run):
    return mean_span(run, "prefill")
