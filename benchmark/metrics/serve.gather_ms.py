"""The batcher's mean gather ms in the traced stretch, from the first
request taken until the batch closes: the program's ``serve.gather``
spans."""

from benchmark import spans


def read(record):
    return spans.mean_ms(record, "serve.gather")
