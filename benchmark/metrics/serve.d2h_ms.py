"""Host ms a dispatch copying outputs and states back, waiting on the
card, in the traced stretch: the ``serve.d2h`` children of
``serve.dispatch``."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "serve.dispatch", "serve.d2h")
