"""The program's own spans (``eve_tpu_torch.tracing``) over a run's traced
stretch.

The program records spans while a torch profiler records, on the
profiler's host clock, so the spans of a ``--trace 1`` run that belong to
its stretch are those inside the stretch's mark. A root span (such as
``serve.dispatch``) is kept, with its children, only when it lies wholly
inside. Every reader gives None without a stretch, with no root in it,
with a program that records no spans (a commit before they came), or when
the program's ring dropped records (its children would be under-counted).
"""


def _spans():
    try:
        from eve_tpu_torch import tracing
    except ImportError:
        return None
    if tracing.dropped():
        return None
    return tracing.spans()


def roots(record, name):
    """``[(root, [its children])]`` of every ``name`` span that lies wholly
    inside the stretch, in order; None without a stretch, without the
    program's spans or after the ring dropped any."""
    stretch = record.get('stretch')
    if stretch is None:
        return None
    found = _spans()
    if found is None:
        return None
    start, stop = stretch.start * 1e9, stretch.stop * 1e9
    kept = {s.id: (s, []) for s in found if s.name == name
            and start <= s.start_ns and s.end_ns <= stop}
    for s in found:
        if s.parent in kept:
            kept[s.parent][1].append(s)
    return list(kept.values())


def children(record, root, child):
    """Every ``child`` span of the ``root`` spans in the stretch (None as
    ``roots``)."""
    found = roots(record, root)
    if found is None:
        return None
    return [c for _, kids in found for c in kids if c.name == child]


def mean_ms(record, root):
    """The ``root`` spans' mean host ms in the stretch."""
    found = roots(record, root)
    if not found:
        return None
    return sum(r.ms for r, _ in found) / len(found)


def ms_per_root(record, root, child, device=False):
    """The ``child`` spans' host ms (``device=True``: their ``device_ms``,
    None where any has none) summed over the ``root`` spans in the
    stretch, over their count."""
    found = roots(record, root)
    if not found:
        return None
    kids = [c for _, cs in found for c in cs if c.name == child]
    values = [c.device_ms if device else c.ms for c in kids]
    if not values or None in values:
        return None
    return sum(values) / len(found)
