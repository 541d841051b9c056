"""The card's busy ms a batch in the traced stretch."""

from benchmark.stats import device_ms_per_unit as read  # noqa: F401
