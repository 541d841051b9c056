"""Host ms a batch copying its inputs to the card, in the traced
stretch: the ``infer.h2d`` children of ``infer.batch``."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "infer.batch", "infer.h2d")
