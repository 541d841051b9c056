"""Slots filled of the dispatches' max_batch slots over the window,
from the engine's counters (batched_slots / (dispatches * max_batch))."""


def read(record):
    if not record["units"]:
        return None
    return 100.0 * record["batched_slots"] / (record["units"] *
                                              record["max_batch"])
