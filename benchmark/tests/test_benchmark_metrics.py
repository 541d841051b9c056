"""The metric arithmetic on synthetic records: the interval union, p95
from the due time with a stall inside the window, batch fill, the
kernels' bytes at the cells' shapes and the reference's operation
counts."""

import threading
import time
from concurrent.futures import Future

import pytest

from benchmark import harness, roofline
from benchmark.reference import flops
from benchmark.trace import Stretch, gaps, union_s
from benchmark.traffic import stream


def _reader(name):
    return harness.reader(name)


def test_union_counts_overlap_once():
    assert union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert union_s([]) == 0
    assert gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4),
                                                        (5, 6)]


def test_stretch_readers():
    s = Stretch(0.0, 1.0, [('k1', 0.0, 0.2), ('Memcpy HtoD', 0.1, 0.3),
                           ('k2', 0.5, 0.6)],
                [('aten::stack', 0.3, 0.5), ('outer', 0.0, 1.0)])
    assert s.busy_s == pytest.approx(0.4)
    assert len(s.kernels()) == 2
    # Each gap is named by the innermost host op at its middle.
    assert s.idle_gaps(2) == [['outer', pytest.approx(0.4)],
                              ['aten::stack', pytest.approx(0.2)]]
    rec = {'stretch': s, 'stretch_units': 2}
    assert _reader('device.idle_pct.stream')(rec) == pytest.approx(60.0)
    assert _reader('eve.device_ms_per_dispatch.stream')(rec) == \
        pytest.approx(200.0)
    assert _reader('eve.launches_per_dispatch.stream')(rec) == 1.0
    assert _reader('train.step_device_ms.train')(
        dict(rec, stretch_units=4)) == pytest.approx(100.0)
    # No card seen: the readers return nothing, never 0.
    empty = dict(rec, stretch=Stretch(0.0, 1.0, [], []))
    assert _reader('device.idle_pct.offline')(empty) is None
    assert _reader('render_heatmaps_roofline')(
        dict(empty, kernel_calls={'render_heatmaps_kernel': {'n': 1}})) \
        is None


def test_every_metric_has_a_reader():
    bench = harness._json(harness.ROOT, 'BENCHMARK.json')
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(harness.reader(m['name'])), m['name']
    # A quantity's reader serves its name in any cell.
    assert harness.reader('device.idle_pct.some-later-cell')(
        {'stretch': Stretch(0.0, 1.0, [('k', 0.0, 0.25)], [])}) == \
        pytest.approx(75.0)
    with pytest.raises(FileNotFoundError):
        harness.reader('no_such_metric.stream')


def test_mfu_over_the_window():
    rec = {'flops_per_unit': 67e12, 'units': 3, 'window_s': 6.0,
           'on_card': True, 'peak_flops_dtype': 'float32'}
    assert _reader('mfu.train')(rec) == pytest.approx(50.0)
    assert _reader('mfu.offline')(dict(rec, on_card=False)) is None


def test_batch_fill():
    rec = {'units': 10, 'batched_slots': 60, 'max_batch': 8}
    assert _reader('serve.batch_fill_pct.stream')(rec) == 75.0


class StallingEngine:
    """Answers each chunk ``service_s`` after it arrives, one at a time,
    and stalls once for ``stall_s`` at ``stall_at``."""

    def __init__(self, service_s, stall_at, stall_s):
        self.service_s, self.stall_at, self.stall_s = (service_s, stall_at,
                                                       stall_s)
        self.free_at = 0.0
        self.lock = threading.Lock()

    def submit(self, inputs, session_id):
        f = Future()
        now = time.perf_counter()
        with self.lock:
            start = max(now, self.free_at)
            if self.stall_at <= start < self.stall_at + self.stall_s:
                start = self.stall_at + self.stall_s
            self.free_at = start + self.service_s
            due = self.free_at
        threading.Timer(max(0.0, due - now),
                        lambda: f.set_result({'ok': 1})).start()
        return f


class FixedSessions:
    def __init__(self, count, period):
        self.phase = [i * period / count for i in range(count)]

    def chunk_inputs(self, i, k):
        return {}


def test_p95_from_due_time_with_a_stall():
    count, period, seconds, stall = 10, 0.1, 1.0, 0.3
    sessions = FixedSessions(count, period)
    t0 = time.perf_counter() + 0.05
    plan = stream.schedule(sessions, count, period, t0, seconds)
    engine = StallingEngine(0.001, t0 + 0.4, stall)
    thread, submitted, done, results, lock = stream.drive(
        engine, sessions, list(range(count)), plan)
    thread.join()
    time.sleep(stall + 0.2)
    lat = [(d - due) * 1e3 for (due, _, _), d in zip(plan, done)]
    assert len(plan) == 100
    # Chunks due in the stall wait for its end: latency from the due time,
    # not from when the engine took them.
    stalled = [x for (due, _, _), x in zip(plan, lat)
               if t0 + 0.4 <= due < t0 + 0.4 + stall]
    assert min(stalled) >= 0.0 and max(stalled) >= 0.8 * stall * 1e3
    p95 = _reader('serve.chunk_p95_ms.stream')({'latencies_ms': lat})
    assert p95 >= 0.5 * stall * 1e3
    # The stall outlasts a period, so the chunks due in its first part
    # were late, and only those.
    late = sum(1 for x in lat if x > period * 1e3)
    assert 0 < late < len(stalled)
    on_time = _reader('chunk_on_time_pct')(
        {'latencies_ms': lat, 'period_ms': period * 1e3})
    assert on_time == pytest.approx(100.0 * (len(lat) - late) / len(lat))
    lag = _reader('loadgen.lag_p95_ms.stream')(
        {'lags_ms': [(s - due) * 1e3 for s, (due, _, _) in
                     zip(submitted, plan)]})
    assert lag < 50.0


def test_kernel_bytes_at_the_cells_shapes():
    n = 128 * 30
    # Render: (n, 2) f32 centres in, one 72 x 128 f32 map per centre out.
    assert roofline.render_bytes(n) == n * 8 + n * 72 * 128 * 4
    assert roofline.render_bytes(8 * 30, sigmas=3, masked=True) == \
        240 * 8 + 240 * 4 + 3 * 240 * 72 * 128 * 4
    # Soft-argmax: the maps in, (n, 2) f32 out.
    assert roofline.soft_argmax_bytes(n) == n * 72 * 128 * 4 + n * 8
    s = Stretch(0.0, 1.0, [('render_heatmaps_kernel', 0.0, 1e-4)], [])
    bound = roofline.render_bytes(n) / roofline.HBM_BYTES_PER_S
    assert roofline.kernel_roofline_pct(
        s, 'render_heatmaps_kernel', {'n': n}) == pytest.approx(
            100 * bound / 1e-4)


def _conv_flops(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw * hw


def _resnet18_flops(size):
    """ResNet-18's convolutions and fc at ``size`` x ``size``, by hand."""
    s = size // 2
    total = _conv_flops(3, 64, 7, s)
    s //= 2
    cin = 64
    for stage, cout in enumerate((64, 128, 256, 512)):
        if stage:
            s //= 2
            total += _conv_flops(cin, cout, 1, s)
        total += _conv_flops(cin, cout, 3, s) + 3 * _conv_flops(cout, cout,
                                                                3, s)
        cin = cout
    return total + 2 * 512 * 128


def test_reference_flop_counts():
    cfg = harness.load_cell('eyenet-f32.train').config['config']
    per_clip = flops.forward(cfg, 1, 1, 128)
    # EyeNet alone: two eyes through ResNet-18, then small dense layers
    # (2 operations a multiply-add), then three 3 x 3 rotations an eye on
    # the way to the screen.
    dense = 2 * 2 * (130 * 128 + 128 * 128 + 2 * 3 * 128 * 128 +
                     128 * 128 + 2 * 128 + 128 * 128 + 128)
    geometry = 2 * 3 * 2 * 9
    assert per_clip == 2 * _resnet18_flops(128) + dense + geometry
    assert flops.forward(cfg, 4, 3, 128) == 12 * per_clip
    # A training step: the forward and twice its work in the backward,
    # less the stem's gradient to the frames, which nothing needs.
    stem = 16 * 30 * 2 * _conv_flops(3, 64, 7, 64)
    assert flops.train_step(cfg, 16, 30, 128) == pytest.approx(
        3 * flops.forward(cfg, 16, 30, 128) - stem, rel=1e-4)
    refine = harness.load_cell('eve-refine-bf16.offline').config['config']
    # The counts the offline cell's mfu reads (pinned: a change to the
    # reference or the cell changes them).
    assert flops.forward(refine, 128, 30, 128) == 21448212894720
    assert flops.train_step(cfg, 16, 30, 128) == 3338310008832
