"""Card ms a batch in Gaze360's per-frame stage (normalisation, the
backbone over every frame, fc1 and fc2), in the traced stretch: the CUDA
event pair of the ``gaze360.backbone`` child of ``infer.batch``. The
stream's elapsed time, idle gaps inside the stage included. None off a
card or under a program without the span."""

from benchmark import spans


def read(record):
    return spans.ms_per_root(record, "infer.batch", "gaze360.backbone",
                             device=True)
