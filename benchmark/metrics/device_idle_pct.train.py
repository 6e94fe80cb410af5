"""The device's idle share of the traced stretch: one minus the union of
its kernel, copy and set intervals over the stretch's host window."""


def read(record):
    tr = record["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
