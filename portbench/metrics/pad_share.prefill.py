"""``pad_share.prefill``: the share of the prefills' token slots that hold
padding and no prompt token, in percent: what packing a wave to one length
(as the program's ``launch/serve.py`` packs it) costs the prefill.  Read
from the prompts the driver packed (``prefill_tokens``)."""


def read(run):
    packed = run.work.get("prefill_tokens")
    if not packed:
        return None
    tokens, slots = packed
    return 100.0 * (1.0 - tokens / slots)
