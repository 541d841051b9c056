"""Spans at the port's layer boundaries, on while a torch profiler records.

The port's one tracing system. ``span(name)`` is a context manager that
is on exactly while a ``torch.profiler.profile`` records (``enabled()``)
and costs one flag read otherwise: it then returns one shared
``contextlib.nullcontext()``, allocates nothing and reads no clock. There
is no other switch: whoever starts a profiler (a benchmark's traced
stretch, the train harness's ``profile_dir`` window) gets the spans.

When on, a span

- enters ``torch.profiler.record_function(name)``, so it shows named and
  nested on the profiler's host timeline, on the same clock as the card's
  activity;
- adds a ``Span`` record to an in-memory ring: name, thread, parent
  record, and start and end ns on the profiler's host clock (``now_ns``,
  Unix-epoch ns);
- with ``device=True``, on a CUDA device outside graph capture, also
  records a CUDA event pair on the current stream, which ``spans()``
  resolves to ``device_ms``.

``record`` stores a span whose start was stamped earlier, possibly on
another thread, with a key (a request's queue wait, keyed by its
session); it goes to the ring only.

Each record's parent is the innermost span open on its thread. The ring
keeps the last ``CAPACITY`` records and counts what it drops
(``dropped()``; ``benchmark/spans.py`` reads nothing from a ring that
dropped). ``spans()`` returns the finished records, oldest first;
``clear()`` empties the ring.

Span names, and the metrics or uses that read them: ``PERF.md`` §3.
"""

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 16

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_ring = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def enabled():
    """Whether a torch profiler records now: the one read of torch's
    private flag, which every ``torch.profiler.profile`` sets from its
    start to its stop."""
    return _autograd_profiler._is_profiler_enabled


def now_ns():
    """The store's clock: the profiler's host clock, Unix-epoch ns."""
    return time.time_ns()


class Span:
    """One record of the ring. ``parent`` is the id of the enclosing
    record (None for a root); ``end_ns`` is None while the span is open;
    ``device_ms`` is the event pair's time once ``spans()`` resolved it,
    else None."""

    __slots__ = ('id', 'name', 'key', 'thread', 'parent', 'start_ns',
                 'end_ns', 'device_ms', 'events')

    def __init__(self, name, key, parent, start_ns, end_ns=None):
        self.id = next(_ids)
        self.name, self.key, self.parent = name, key, parent
        self.thread = threading.get_ident()
        self.start_ns, self.end_ns = start_ns, end_ns
        self.device_ms = self.events = None

    @property
    def ms(self):
        """Host ms from start to end."""
        return (self.end_ns - self.start_ns) * 1e-6


def _open_spans():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _parent_id():
    stack = _open_spans()
    return stack[-1].id if stack else None


def _store(record):
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(record)


class _Recording:
    __slots__ = ('name', 'device', 'function', 'span')

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        span = self.span = Span(self.name, None, _parent_id(), now_ns())
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            span.events = (start, None)
        _store(span)
        _open_spans().append(span)
        return span

    def __exit__(self, *exc):
        span = self.span
        stack = _open_spans()
        if stack and stack[-1] is span:
            stack.pop()
        if span.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            span.events = (span.events[0], end)
        span.end_ns = now_ns()
        self.function.__exit__(*exc)
        return False


def span(name, device=False):
    """A span ``name`` around the block (see the module docstring): the
    shared null context while no profiler records. Entered, it gives its
    ``Span`` (None when off)."""
    if not enabled():
        return _OFF
    return _Recording(name, device)


def record(name, start_ns, end_ns, key=None):
    """Store a finished span stamped earlier on the store's clock, keyed
    by ``key`` (the ring only, no profiler event). Returns the ``Span``, or
    None while no profiler records."""
    if not enabled():
        return None
    span = Span(name, key, _parent_id(), start_ns, end_ns)
    _store(span)
    return span


def spans():
    """The finished records, oldest first, each event pair resolved to
    ``device_ms`` (waiting once for the card to reach the pending ones)."""
    with _lock:
        done = [s for s in _ring if s.end_ns is not None]
        for s in done:
            if s.events is not None:
                start, end = s.events
                end.synchronize()
                s.device_ms = start.elapsed_time(end)
                s.events = None
    return done


def dropped():
    """Records the ring has dropped since the last ``clear()``."""
    return _dropped


def clear():
    """Empty the ring and reset the drop count."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0
