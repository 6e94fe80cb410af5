"""Set-up: process start to the first timed unit of work (host clock)."""


def read(record):
    return record["setup_s"]
