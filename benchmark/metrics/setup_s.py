"""Set-up: process start to the window's start, in s."""


def read(record):
    return record["setup_s"]
