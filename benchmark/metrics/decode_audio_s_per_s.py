"""Audio seconds of every batch decoded in the window, over the whole
window (host clock)."""


def read(record):
    return record["audio_s"] / record["window_s"]
