"""The port's spans (``eve_tpu_torch.tracing``) on the CPU: off without a
profiler, on the profiler's own clock and nested under one, stamped
records, the bounded ring, and the profiler flag they read."""

import collections
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eve_tpu_torch import tracing


def all_threads_profiler():
    """A CPU profiler that records every thread's host ops, as the
    benchmark's tracer does."""
    from torch._C._profiler import _ExperimentalConfig
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def test_off_without_a_profiler():
    assert not tracing.enabled()
    first = tracing.span('a', device=True)
    assert first is tracing.span('b') is tracing._OFF
    with first as got:
        assert got is None
    assert tracing.record('c', 0, 1) is None
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_the_flag_tracing_reads():
    """``enabled()`` reads torch's private flag: a torch that renames or
    stops setting it fails here rather than leaving the spans off."""
    from torch.autograd import profiler as autograd_profiler
    assert hasattr(autograd_profiler, '_is_profiler_enabled')
    assert autograd_profiler._is_profiler_enabled is False
    prof = all_threads_profiler()
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled is True
        assert tracing.enabled()
    finally:
        prof.stop()
    assert not tracing.enabled()


RECORDS = ('inner.wait', 'worker.wait')


def _traced_tree():
    """Spans nested on this thread and on a worker thread under one
    profiler, each inner one holding a keyed record: ``(profiler, {name:
    Span})``."""
    with all_threads_profiler() as prof:
        with tracing.span('outer'):
            with tracing.span('inner'):
                torch.ones(64).sum()
                time.sleep(0.002)
                tracing.record('inner.wait', tracing.now_ns(),
                               tracing.now_ns(), key='k1')

            def work():
                with tracing.span('worker'):
                    with tracing.span('worker.inner'):
                        time.sleep(0.002)
                        tracing.record('worker.wait', tracing.now_ns(),
                                       tracing.now_ns(), key=3)
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()
    return prof, {s.name: s for s in tracing.spans()}


@pytest.mark.parametrize('name,parent,key,other_thread', [
    ('outer', None, None, False),
    ('inner', 'outer', None, False),
    ('inner.wait', 'inner', 'k1', False),
    ('worker', None, None, True),
    ('worker.inner', 'worker', None, True),
    ('worker.wait', 'worker.inner', 3, True),
])
def test_spans_nest_with_parents_and_keys(name, parent, key, other_thread):
    _, got = _traced_tree()
    assert set(got) == {'outer', 'inner', 'worker', 'worker.inner',
                        *RECORDS}
    span = got[name]
    assert span.parent == (got[parent].id if parent else None)
    assert span.key == key
    assert (span.thread != got['outer'].thread) == other_thread
    assert 0 <= span.ms < 10_000 and span.device_ms is None


def test_one_clock_with_the_profiler():
    """Each stored interval lies within the profiler's own event of the
    same name, to 1 ms."""
    prof, got = _traced_tree()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name, span in got.items():
        if name in RECORDS:
            assert name not in events, name
            continue
        assert len(events.get(name, ())) == 1, name
        (start, end), = events[name]
        assert start - 1_000_000 <= span.start_ns, name
        assert span.end_ns <= end + 1_000_000, name
        assert span.start_ns <= span.end_ns


def test_record_with_an_earlier_start():
    with all_threads_profiler():
        start = tracing.now_ns()
        time.sleep(0.003)
        with tracing.span('dispatch') as dispatch:
            late = tracing.record('wait', start, dispatch.start_ns, key='s')
        loose = tracing.record('loose', start, tracing.now_ns())
    got = {s.name: s for s in tracing.spans()}
    assert got['wait'] is late and got['wait'].key == 's'
    assert got['wait'].parent == got['dispatch'].id
    assert got['wait'].ms >= 3.0
    assert got['loose'] is loose and loose.parent is None


def test_the_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, '_ring', collections.deque(maxlen=4))
    with all_threads_profiler():
        for i in range(7):
            tracing.record('s', i, i + 1, key=i)
    assert [s.key for s in tracing.spans()] == [3, 4, 5, 6]
    assert tracing.dropped() == 3
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0
