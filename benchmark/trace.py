"""The traced stretch of a ``--trace 1`` run, read into plain numbers.

``torch.profiler`` records the host's ops and the card's activity over a
short steady stretch of the window. Its raw events are read once into a
``Stretch``: the card's intervals (kernels, copies and sets), the kernels'
names and times, and the host's ops, with the stretch's length. The busy
time is the union of the card's intervals, so work on overlapping streams
counts once: the arithmetic of the program's ``bench.common.union_ms``,
frozen here.
"""

import dataclasses
import sys
import time
from typing import List, Tuple

import torch

NON_KERNEL_PREFIXES = ('Memcpy', 'Memset', 'memcpy', 'memset')


def union_s(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float('inf')
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, start, stop):
    """The idle ``(start, end)`` stretches between ``start`` and ``stop``
    that no interval covers, longest first."""
    out, end = [], start
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, stop)))
        end = max(end, b)
        if end >= stop:
            break
    if end < stop:
        out.append((end, stop))
    return sorted((g for g in out if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


@dataclasses.dataclass
class Stretch:
    """What the profiler saw, in seconds on one clock."""
    start: float
    stop: float
    device: List[Tuple[str, float, float]]   # (name, start, end)
    host: List[Tuple[str, float, float]]

    @property
    def window_s(self):
        return self.stop - self.start

    @property
    def busy_s(self):
        return union_s([(a, b) for _, a, b in self.device])

    def kernels(self, name_part=None):
        """The kernel launches (no copies or sets), optionally those whose
        name holds ``name_part``: ``[(name, seconds)]``."""
        return [(n, b - a) for n, a, b in self.device
                if not n.startswith(NON_KERNEL_PREFIXES)
                and (name_part is None or name_part in n)]

    def top_device_ops(self, n=10):
        totals = {}
        for name, a, b in self.device:
            totals[name] = totals.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The ``n`` longest idle gaps of the card, each named by the
        innermost host op running at its middle."""
        out = []
        for a, b in gaps([(x, y) for _, x, y in self.device], self.start,
                         self.stop)[:n]:
            mid = 0.5 * (a + b)
            running = [(y - x, name) for name, x, y in self.host
                       if x <= mid <= y]
            out.append([min(running)[1] if running else 'no host op',
                        b - a])
        return out


class Tracer:
    """Starts and stops ``torch.profiler`` around a stretch of the window.
    ``read()`` turns what it saw into a ``Stretch``: call it once the
    window is over, since reading the events holds the interpreter for a
    while."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        self._device = device
        # A first profiler in a process starts the card's tracer, which
        # takes seconds and holds the interpreter: do it in set-up, on an
        # op of nothing, so that starting the traced stretch is quick.
        with profile(activities=activities,
                     experimental_config=_all_threads()):
            torch.zeros(1, device=device).add_(1)
            self._sync()
        self._prof = profile(activities=activities,
                             experimental_config=_all_threads())
        self.stopped = False
        self._stretch = None
        self.seconds = {}

    def _sync(self):
        if self._device.type == 'cuda':
            torch.cuda.synchronize(self._device)

    def start(self):
        self._sync()
        t = time.perf_counter()
        self._prof.start()
        # A host span from start to stop marks the stretch on the
        # profiler's own clock.
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self._open = True
        self.seconds['start'] = time.perf_counter() - t

    def end(self):
        """End the stretch; the profiler records on until ``stop``, and
        what it records after the end is left out."""
        self._sync()
        self._mark.__exit__(None, None, None)
        self._open = False

    def stop(self):
        """End the stretch if it is open, and stop the profiler (which
        holds the interpreter while it gathers its events)."""
        if self._open:
            self.end()
        t = time.perf_counter()
        self._prof.stop()
        self.seconds['stop'] = time.perf_counter() - t
        self.stopped = True

    def read(self):
        if self._stretch is None:
            t = time.perf_counter()
            self._stretch = _read(self._prof)
            self.seconds['read'] = time.perf_counter() - t
            print('profiler seconds: %s' % self.seconds, file=sys.stderr)
        return self._stretch


MARK = 'benchmark.stretch'


def _all_threads():
    """The profiler's option to record the host ops of every thread (the
    engine's batcher and the load generator run in threads of their own);
    a torch without it records the starting thread's alone."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        print('torch %s cannot profile every thread: idle gaps are named '
              'by the host ops of the tracing thread only'
              % torch.__version__, file=sys.stderr)
        return _ExperimentalConfig()


def _read(prof):
    """The profiler's raw events (``prof.profiler.kineto_results``, which
    torch does not document: a release without it raises here, never a
    quieter number) as a ``Stretch`` bounded by the ``MARK`` span."""
    from torch.autograd import DeviceType
    results = getattr(getattr(prof, 'profiler', None), 'kineto_results',
                      None)
    if results is None:
        raise RuntimeError('this torch (%s) has no profiler.kineto_results'
                           % torch.__version__)
    device, host = [], []
    for e in results.events():
        item = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not e.is_user_annotation() and e.name() != MARK:
            # A host span shows on the card's timeline as an annotation:
            # it is not the card's work.
            device.append(item)
    marks = [(a, b) for name, a, b in host if name == MARK]
    if len(marks) != 1:
        raise RuntimeError('the profiler recorded %d %s spans, not 1'
                           % (len(marks), MARK))
    (start, stop), = marks
    device = [(n, max(a, start), min(b, stop)) for n, a, b in device
              if b > start and a < stop]
    return Stretch(start, stop, device, [h for h in host if h[0] != MARK])
