"""The 95th percentile of every request's wait in the engine's queue,
from its submit to the start of its dispatch, in ms: the program's
``serve.queue_wait`` spans of the dispatches in the traced stretch."""

from benchmark import spans, stats


def read(record):
    waits = spans.children(record, "serve.dispatch", "serve.queue_wait")
    return None if not waits else stats.percentile([w.ms for w in waits], 95)
