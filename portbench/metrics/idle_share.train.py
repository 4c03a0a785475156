"""``idle_share.train``: the share of the traced window in which no operation
ran on the device, in percent (``portbench/trace.py``)."""


def read(run):
    share = run.tracing.idle_share if run.tracing is not None else None
    return None if share is None else 100.0 * share
