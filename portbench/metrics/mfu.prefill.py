"""``mfu.prefill``: the prefill steps' share of the card's roofline, in percent:
the least time their operations and bytes need at the H100's peaks
(``portbench/roofline.py``), over their measured device time (span
``prefill``).  The power limit is printed beside every run."""
from portbench.readers import step_share


def read(run):
    return step_share(run, "prefill")
