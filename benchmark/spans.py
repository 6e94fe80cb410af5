"""The port's spans (``pika_tpu_torch/utils/profiling.py:span``) in the
stretch traced with the host: their host intervals, kept in ``Trace.host``
as every host event is, against the device's busy intervals.

A span opens only while a profiler runs, so spans show in the traced
stretches and nowhere else; a program without them reads nothing here.
Device idle time while the host is inside a span is the method of
``Trace.idle_gaps``: the complement of the union of the device's
intervals over the stretch's window, here intersected with the union of
the span's host intervals."""

from __future__ import annotations

from collections import defaultdict

LOSS_DP = ("loss.alpha", "loss.occupancy")
PROGRAM = ("train.step", "features", "encoder", "prediction_net", "loss.k1", "loss.alpha",
           "train.backward", "loss.occupancy", "loss.k23", "optimizer", "decode.loop",
           "decode.flag_read")
NO_SPAN = "no span"


def merge(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def host_intervals(tr, names) -> list:
    """The union of the host intervals of the spans named in ``names``,
    within the window."""
    return merge((max(s, tr.t0), min(e, tr.t1)) for n, s, e in tr.host
                 if n in names and e > tr.t0 and s < tr.t1)


def idle_intervals(tr) -> list:
    edges = [tr.t0] + [x for iv in tr.busy_intervals() for x in iv] + [tr.t1]
    return [[s, e] for s, e in zip(edges[::2], edges[1::2]) if e > s]


def overlap_s(a: list, b: list) -> float:
    """Seconds two sorted, merged lists of intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_ms(record: dict, names) -> float | None:
    """Device idle milliseconds a unit while the host is inside a span named
    in ``names``; None without a stretch traced with the host, without
    device work in it or without such a span."""
    tr = None if record["trace"] is None else record["trace"].host_trace
    if tr is None or not tr.device:
        return None
    spans = host_intervals(tr, names)
    if not spans:
        return None
    return 1000.0 * overlap_s(idle_intervals(tr), spans) / tr.units


def idle_by_span(tr, names=PROGRAM) -> dict:
    """Every idle second of the window by the innermost span named in
    ``names`` that the host was inside (the latest to start), ``NO_SPAN``
    where it was inside none."""
    spans = sorted((max(s, tr.t0), min(e, tr.t1), n) for n, s, e in tr.host
                   if n in names and e > tr.t0 and s < tr.t1)
    idle = idle_intervals(tr)
    cuts = sorted({x for s, e, _ in spans for x in (s, e)} | {x for iv in idle for x in iv})
    total, active, i, j = defaultdict(float), [], 0, 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][0] <= a:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > a]
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a:
            inner = max(active, key=lambda s: (s[0], -s[1]), default=None)
            total[inner[2] if inner else NO_SPAN] += b - a
    return dict(total)
