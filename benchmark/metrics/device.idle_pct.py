"""The card's idle share of the traced stretch, in %: 1 - the
union of its busy intervals over the stretch."""

from benchmark import stats


def read(record):
    share = stats.busy_share(record)
    return None if share is None else 100.0 * (1.0 - share)
