"""Device idle time a step while the host is inside the Conformer
encoder's spans (``models/conformer.py``): ``conformer.subsample`` and,
in each block, ``conformer.ffn``, ``conformer.mhsa`` and ``conformer.conv``,
in the stretch traced with the host (device trace)."""

from benchmark import spans

CONFORMER = ("conformer.subsample", "conformer.ffn", "conformer.mhsa", "conformer.conv")


def read(record):
    return spans.idle_under_ms(record, CONFORMER)
