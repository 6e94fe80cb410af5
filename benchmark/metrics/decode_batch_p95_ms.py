"""The 95th percentile of the window's batch latencies, each from the
featurizer's call to the N-best on the host (host clock): the smallest
latency that at least 95 % of the batches do not exceed."""

import math


def read(record):
    lat = sorted(record["latencies"])
    return 1000.0 * lat[math.ceil(0.95 * len(lat)) - 1]
