"""Frames Gaze360's backbone ran a batch, in the traced stretch: the key
of the ``gaze360.backbone`` spans (B*T when each frame runs once; 7 B*T
when every window recomputes its frames). None under a program without
the span."""

from benchmark import spans


def read(record):
    found = spans.children(record, "infer.batch", "gaze360.backbone")
    if not found:
        return None
    return float(sum(s.key for s in found)) / len(found)
