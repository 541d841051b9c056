"""The readers of the program's spans (``benchmark/spans.py`` and the
``program_span`` metrics): known values from a hand-made store and
stretch, nothing without a stretch, without the program's spans or after
its ring dropped records, and a value for each host-span metric in a
traced run of each cell on the CPU (None for the card's event times
there)."""

import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny
from benchmark.trace import Stretch

S = 1_000_000_000  # ns a second
MS = 1_000_000     # ns a ms


def _store():
    """Spans as ``eve_tpu_torch.tracing.spans()`` gives them, around a
    stretch from 100 s to 101 s: two dispatches, two batches and two steps
    inside it, and roots that reach past either end (left out)."""
    from eve_tpu_torch.tracing import Span
    out = []

    def add(name, start, ms, parent=None, key=None, device_ms=None):
        s = Span(name, key, parent.id if parent else None, start,
                 start + int(ms * MS))
        s.device_ms = device_ms
        out.append(s)
        return s

    for t0, ms, stack, h2d, fwd, d2h, waits in (
            (100.1, 50, 5, (4, 6), 20, (8, 2), (10, 20, 30)),
            (100.5, 60, 3, (7,), 30, (12,), (40,)),
            (100.99, 30, 1, (1,), 1, (1,), (500,))):   # ends past the stop
        start = int(t0 * S)
        add('serve.gather', start - 10 * MS, 10)
        root = add('serve.dispatch', start, ms)
        for i, w in enumerate(waits):
            add('serve.queue_wait', start - int(w * MS), w, root, 's%d' % i)
        add('serve.stack', start, stack, root)
        for a in h2d:
            add('serve.h2d', start, a, root)
        add('serve.forward', start, fwd, root)
        for a in d2h:
            add('serve.d2h', start, a, root)
    add('serve.gather', int(99.995 * S), 10)      # starts before the start
    for t0, h2d, d2h in ((100.2, 80, 5), (100.6, 90, 7), (99.9, 1, 1)):
        root = add('infer.batch', int(t0 * S), 100)
        add('infer.h2d', int(t0 * S), h2d, root)
        add('infer.d2h', int(t0 * S), d2h, root)
    for t0, fwd, bwd, upd in ((100.3, 50, 100, 10), (100.7, 52, 110, 12)):
        root = add('train.step', int(t0 * S), 200)
        add('train.forward', int(t0 * S), 60, root, device_ms=fwd)
        add('train.backward', int(t0 * S), 100, root, device_ms=bwd)
        add('train.update', int(t0 * S), 20, root, device_ms=upd)
    return out


KNOWN = {
    'serve.queue_wait_p95_ms.stream': 38.5,   # numpy's p95 of 10-40 ms
    'serve.gather_ms.stream': 10.0,
    'serve.dispatch_ms.stream': 55.0,
    'serve.stack_ms.stream': 4.0,
    'serve.h2d_ms.stream': 8.5,
    'serve.forward_launch_ms.stream': 25.0,
    'serve.d2h_ms.stream': 11.0,
    'infer.h2d_ms.offline': 85.0,
    'infer.d2h_ms.offline': 6.0,
    'train.forward_device_ms.train': 51.0,
    'train.backward_device_ms.train': 105.0,
    'train.update_device_ms.train': 11.0,
}


def _span_metrics():
    bench = harness._json(harness.ROOT, 'BENCHMARK.json')
    return {m['name']: m for m in bench['per_layer']
            if m['source'] == 'program_span'}


def test_the_span_metrics_are_declared():
    assert set(_span_metrics()) == set(KNOWN)


@pytest.mark.parametrize('metric', sorted(KNOWN))
def test_readers_on_a_hand_made_store(metric, monkeypatch):
    from eve_tpu_torch import tracing
    monkeypatch.setattr(tracing, 'spans', _store)
    read = harness.reader(metric)
    record = {'stretch': Stretch(100.0, 101.0, [], [])}
    assert read(record) == pytest.approx(KNOWN[metric], rel=1e-6)
    assert read({'stretch': None}) is None
    # A stretch that holds no root reads nothing.
    assert read({'stretch': Stretch(200.0, 201.0, [], [])}) is None
    if metric.startswith('train.'):
        # Off a card the phases carry no event time.
        def off_card():
            found = _store()
            for s in found:
                s.device_ms = None
            return found
        monkeypatch.setattr(tracing, 'spans', off_card)
        assert read(record) is None


@pytest.mark.parametrize('metric', sorted(KNOWN))
def test_a_program_without_spans_reads_nothing(metric, monkeypatch):
    """An earlier commit of the program has no ``tracing`` module: its
    traced runs leave these metrics out, without raising."""
    import eve_tpu_torch
    from eve_tpu_torch import tracing
    monkeypatch.setattr(tracing, 'spans', _store)
    monkeypatch.delattr(eve_tpu_torch, 'tracing')
    monkeypatch.setitem(sys.modules, 'eve_tpu_torch.tracing', None)
    assert harness.reader(metric)(
        {'stretch': Stretch(100.0, 101.0, [], [])}) is None


@pytest.mark.parametrize('metric', sorted(KNOWN))
def test_a_ring_that_dropped_reads_nothing(metric, monkeypatch):
    """Once the program's ring has dropped records, a root's children may
    be missing, so no reader gives a value."""
    from eve_tpu_torch import tracing
    monkeypatch.setattr(tracing, 'spans', _store)
    monkeypatch.setattr(tracing, '_dropped', 1)
    assert harness.reader(metric)(
        {'stretch': Stretch(100.0, 101.0, [], [])}) is None


@pytest.mark.parametrize('cell', tiny.CELLS)
def test_a_traced_run_reports_the_host_spans(cell):
    from eve_tpu_torch import tracing
    tracing.clear()
    result = tiny.measure(cell, trace=1)
    tracing.clear()
    assert result['correct']
    mine = [m for m, e in _span_metrics().items() if cell in e['workloads']]
    assert mine
    for metric in mine:
        if '_device_ms' in metric:
            assert metric not in result['metrics'], metric
        else:
            value = result['metrics'][metric]['value']
            assert value >= 0.0 and result['metrics'][metric]['unit'] == 'ms'
