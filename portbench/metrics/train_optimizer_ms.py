"""``train_optimizer_ms``: the mean device time of the compiled train step's
optimizer phase in the window's replays, in ms: the donated AdamW update
(``optim/optimizer.py``), timed by the pair of events the program captures
into the step's graph around it (span ``train.optimizer`` of
``train/train_step.py``), summed over the microbatches."""
from portbench.port_spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "train.optimizer", "train")
