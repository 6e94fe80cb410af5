"""Device idle time a batch while the host is inside ``decode.loop``
(``DecodeLoop.run``: the reset, the graph's replays and the reads of the
device flag), in the stretch traced with the host (device trace)."""

from benchmark import spans


def read(record):
    return spans.idle_under_ms(record, ("decode.loop",))
