"""``train_step_ms``: the mean device time of a train step in the window,
from the CUDA events the driver records around each call of the program's
compiled train step (span ``train``)."""
from portbench.readers import mean_span


def read(run):
    return mean_span(run, "train")
