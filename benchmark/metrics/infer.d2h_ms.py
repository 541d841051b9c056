"""Host ms a batch copying its outputs back, waiting on the card, in
the traced stretch: the ``infer.d2h`` children of ``infer.batch``."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "infer.batch", "infer.d2h")
