"""Host ms a dispatch stacking its inputs and states with numpy, in the
traced stretch: the ``serve.stack`` children of ``serve.dispatch``."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "serve.dispatch", "serve.stack")
