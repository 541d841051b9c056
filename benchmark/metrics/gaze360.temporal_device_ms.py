"""Card ms a batch in Gaze360's temporal stage (the window gather, the
bidirectional LSTM and the head), in the traced stretch: the CUDA event
pair of the ``gaze360.temporal`` child of ``infer.batch``. None off a
card or under a program without the span."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "infer.batch", "gaze360.temporal",
                             device=True)
