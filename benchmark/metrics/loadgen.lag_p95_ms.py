"""The load generator's lateness: the 95th percentile of submit
time minus due time, in ms."""

from benchmark import stats


def read(record):
    return stats.percentile(record["lags_ms"], 95)
