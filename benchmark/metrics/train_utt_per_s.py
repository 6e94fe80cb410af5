"""Utterances of every training step completed in the window, over the
whole window (host clock)."""


def read(record):
    return record["utterances"] / record["window_s"]
