"""Gaze360's per-frame stage's share of the chip's peak, in %: the
reference's backbone operations a batch (once a frame) over the stage's
card ms a batch (``gaze360.backbone_device_ms``) and the peak of the
configuration's compute type."""

from benchmark import roofline, spans


def read(record):
    flops = record.get("backbone_flops_per_unit")
    if flops is None or not record.get("on_card"):
        return None
    ms = spans.ms_per_root(record, "infer.batch", "gaze360.backbone",
                           device=True)
    if not ms:
        return None
    peak = roofline.PEAK_FLOPS[record["peak_flops_dtype"]]
    return 100.0 * flops / (ms * 1e-3 * peak)
