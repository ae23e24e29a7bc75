"""Set-up seconds: loading, the inputs and weights, kernel builds and
warm-up, up to the window's start (host clock)."""


def read(record):
    return record["setup_s"]
