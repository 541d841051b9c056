"""A dispatch's mean host ms in the traced stretch: the program's
``serve.dispatch`` spans, from the batch closing to its results handed
back."""

from benchmark import spans


def read(record):
    return spans.mean_ms(record, "serve.dispatch")
