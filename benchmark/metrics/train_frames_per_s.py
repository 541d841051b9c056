"""Frames trained in the window over the window's time."""

from benchmark.stats import frames_per_s as read  # noqa: F401
