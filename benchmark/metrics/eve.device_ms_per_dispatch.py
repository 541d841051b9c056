"""The card's busy ms a dispatch in the traced stretch: the union of
its kernels, copies and sets over the engine's dispatches there."""

from benchmark.stats import device_ms_per_unit as read  # noqa: F401
