"""``train_forward_ms``: the mean device time of the compiled train step's
forward phase in the window's replays, in ms: the loss (the model's
forward and the cross-entropy), timed by the pair of events the program
captures into the step's graph around it (span ``train.forward`` of
``train/train_step.py``), summed over the microbatches."""
from portbench.port_spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "train.forward", "train")
