"""The share of every chunk due in the window that was answered before
its session's next chunk was due (one period after its own due time),
in %; a failed chunk counts as late."""


def read(record):
    lat = record["latencies_ms"]
    if not lat:
        return None
    period = record["period_ms"]
    return 100.0 * sum(1 for x in lat if x <= period) / len(lat)
