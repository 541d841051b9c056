"""Host ms a dispatch launching the eager forward, in the traced
stretch: the ``serve.forward`` children of ``serve.dispatch``."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "serve.dispatch", "serve.forward")
