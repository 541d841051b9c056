"""Card ms a training step in its update, in the traced stretch: the
elapsed time between the CUDA event pair that the ``train.update`` child of
``train.step`` records on the current stream. It is the stream's elapsed
time, idle gaps inside the phase included, not the card's busy time:
compare sums of the phases with ``train.step_device_ms.train`` (busy
kernel time a step). None off a card."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "train.step", "train.update",
                             device=True)
