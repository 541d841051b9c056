"""The 95th percentile of every chunk's latency from its due time,
in ms; a failed chunk counts with the wait until the run gave up on it."""

from benchmark import stats


def read(record):
    return stats.percentile(record["latencies_ms"], 95)
