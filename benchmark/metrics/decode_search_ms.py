"""The median batch's span from the call of ``beam_search_features`` to
its N-best on the host, in the window (host clock).  The featurizer's
device work still queued when the search is called falls in the span."""

import statistics


def read(record):
    spans = record.get("spans", {}).get("search")
    return 1000.0 * statistics.median(spans) if spans else None
