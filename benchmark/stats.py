"""Small statistics the metric readers share."""

import numpy as np


def percentile(values, q):
    """The ``q``-th percentile of every value (numpy's linear rule)."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def busy_share(record):
    """The card's busy share of the traced stretch, or None without a
    stretch that saw the card."""
    stretch = record.get('stretch')
    if stretch is None or not stretch.device or stretch.window_s <= 0:
        return None
    return stretch.busy_s / stretch.window_s


def per(value, count):
    return None if value is None or not count else value / count


def frames_per_s(record):
    """Every frame of the window's work over the window's time."""
    return record['frames'] / record['window_s']


def device_ms_per_unit(record):
    """The card's busy ms a unit of work (a dispatch, a batch, a step) in
    the traced stretch, or None without a stretch that saw the card."""
    if busy_share(record) is None:
        return None
    return per(record['stretch'].busy_s * 1e3, record['stretch_units'])
