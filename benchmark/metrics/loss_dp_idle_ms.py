"""Device idle time a step while the host is inside the loss DP's spans,
``loss.alpha`` (``rnnt_alpha``'s row loop and the loss gather) and
``loss.occupancy`` (``rnnt_beta``'s row loop, the arc posteriors and the
channel cotangents), in the stretch traced with the host (device trace)."""

from benchmark import spans


def read(record):
    return spans.idle_under_ms(record, spans.LOSS_DP)
