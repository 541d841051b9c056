"""Host ms a dispatch copying its inputs and states to the card, in the
traced stretch: the ``serve.h2d`` children of ``serve.dispatch``."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "serve.dispatch", "serve.h2d")
