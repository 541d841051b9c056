"""The whole window's share of the chip's peak, in %: the reference's
operations a unit of work (a batch, a training step) times the units,
over the window's time and the peak of the configuration's compute type
(float32 with TF32 off for a float32 configuration)."""

from benchmark import roofline


def read(record):
    if record.get("flops_per_unit") is None or not record.get("on_card"):
        return None
    peak = roofline.PEAK_FLOPS[record["peak_flops_dtype"]]
    return 100.0 * record["flops_per_unit"] * record["units"] / (
        record["window_s"] * peak)
