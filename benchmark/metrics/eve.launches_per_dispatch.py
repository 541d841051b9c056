"""Kernel launches on the card a dispatch in the traced stretch."""

from benchmark import stats


def read(record):
    if stats.busy_share(record) is None:
        return None
    return stats.per(len(record["stretch"].kernels()),
                     record["stretch_units"])
