"""The face cell on the CPU: its readers on hand-built records, its
operation counts against the hand count, and the cell rehearsed at a tiny
size (sound runs correct and loading no JAX; a wrong window gather
caught).

At the tiny size the rehearsal computes in float32, where the program
equals the reference to rounding, so the cell's limits (set for bfloat16
at its size) give way to the tiny size's own (``TINY_LIMITS``): sound
float32 runs read 2.3e-6 degrees and 9.6e-5 px (a CPU); windows that wrap
around the clip read 0.031 degrees and 1.2 px.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, run, spans
from benchmark.reference import eve as ref, gaze360, work
from benchmark.trace import Stretch
from benchmark.traffic import face_offline
from eve_tpu_torch import tracing

SEED = 2 ** 31 + 18
FACE = 'gaze360-bf16.face_offline'
TINY_CONFIG = dict(face_size=[64, 64], test_batch_size=2, max_sequence_len=9)
TINY = dict(trace_batches=[1, 2], check_block_clips=1)
TINY_LIMITS = {'gaze_deg_mean': 1e-3, 'pog_px_mean': 0.05}


def tiny_cell(name):
    cell = harness.load_cell(name)
    cell.params.update(TINY)
    cell.config['config'].update(TINY_CONFIG, tpu_compute_dtype='float32')
    cell.limits.update(TINY_LIMITS)
    return cell


def measure(name, seconds=1.0, trace=1, seed=SEED):
    torch.set_num_threads(2)
    result, _ = run.measure(tiny_cell(name), seed, seconds, trace,
                            torch.device('cpu'), start=time.perf_counter())
    return result


# ----------------------------------------------------------------------
# Readers
# ----------------------------------------------------------------------

def _span(name, parent, start_s, end_s, device_ms=None, key=None):
    s = tracing.Span(name, key, parent, int(start_s * 1e9), int(end_s * 1e9))
    s.device_ms = device_ms
    return s


@pytest.fixture
def face_record(monkeypatch):
    """Two traced batches inside the stretch and one outside it."""
    found = []
    for i, (a, b) in enumerate(((1.0, 1.4), (1.5, 1.9), (2.5, 2.9))):
        root = _span('infer.batch', None, a, b)
        found += [root,
                  _span('gaze360.backbone', root.id, a, a + 0.2,
                        device_ms=40.0 + i, key=3840),
                  _span('gaze360.temporal', root.id, a + 0.2, a + 0.3,
                        device_ms=10.0 + i)]
    monkeypatch.setattr(spans, '_spans', lambda: found)
    stretch = Stretch(0.9, 2.0, [('conv', 1.0, 1.3), ('lstm', 1.5, 1.8)],
                      [])
    return {'stretch': stretch, 'stretch_units': 2, 'on_card': True,
            'backbone_flops_per_unit': 13.934e12,
            'flops_per_unit': 14.075e12, 'units': 100, 'window_s': 50.0,
            'peak_flops_dtype': 'bfloat16'}


@pytest.mark.parametrize('metric,want', [
    ('gaze360.backbone_device_ms.face_offline', 40.5),
    ('gaze360.temporal_device_ms.face_offline', 10.5),
    ('gaze360.backbone_frames.face_offline', 3840.0),
    ('gaze360.backbone_mfu.face_offline',
     100.0 * 13.934e12 / (40.5e-3 * 989e12)),
    ('gaze360.device_ms_per_batch.face_offline', 300.0),
    ('mfu.face_offline', 100.0 * 14.075e12 * 100 / (50.0 * 989e12)),
])
def test_face_readers_on_a_hand_built_record(face_record, metric, want):
    assert harness.reader(metric)(face_record) == pytest.approx(want)


@pytest.mark.parametrize('metric', [
    'gaze360.backbone_device_ms.face_offline',
    'gaze360.temporal_device_ms.face_offline',
    'gaze360.backbone_frames.face_offline',
    'gaze360.backbone_mfu.face_offline'])
def test_face_readers_read_nothing_without_the_spans(monkeypatch, metric):
    """The parent commit's program records no Gaze360 span: its readers
    give nothing and do not raise."""
    monkeypatch.setattr(spans, '_spans', lambda: [
        _span('infer.batch', None, 1.0, 1.4)])
    record = {'stretch': Stretch(0.9, 2.0, [('k', 1.0, 1.1)], []),
              'stretch_units': 2, 'on_card': True,
              'backbone_flops_per_unit': 1e12,
              'peak_flops_dtype': 'bfloat16'}
    assert harness.reader(metric)(record) is None
    assert harness.reader(metric)(dict(record, stretch=None)) is None


# ----------------------------------------------------------------------
# Operation counts
# ----------------------------------------------------------------------

def _conv_flops(cout, cin, k, out_px):
    return 2 * cout * cin * k * k * out_px * out_px


def test_gaze360_counts_equal_the_hand_count():
    # ResNet-18 at 224: the stem to 112, the stages at 56, 28, 14 and 7.
    backbone = _conv_flops(64, 3, 7, 112)
    cin = 64
    for cout, px in ((64, 56), (128, 28), (256, 14), (512, 7)):
        for b in range(2):
            first = cin if b == 0 else cout
            backbone += _conv_flops(cout, first, 3, px)
            backbone += _conv_flops(cout, cout, 3, px)
            if b == 0 and cout != 64:
                backbone += _conv_flops(cout, first, 1, px)
        cin = cout
    backbone += 2 * (512 * 1000 + 1000 * 256)
    assert work.gaze360_backbone({}, 1, 224) == backbone
    assert backbone / 1e9 == pytest.approx(3.63, abs=0.005)
    # Two directions of 7 steps a layer: 4 gates of 256 over [x; h].
    lstm = 2 * 7 * 2 * 4 * 256 * ((256 + 256) + (512 + 256))
    window = lstm + 2 * 512 * 3
    assert work.gaze360_temporal({}, 1) == window
    assert window / 1e6 == pytest.approx(36.7, abs=0.05)
    # A Codalab batch: each frame once, each window once.
    assert work.gaze360_backbone({}, 3840, 224) == 3840 * backbone
    assert work.gaze360_temporal({}, 3840) == 3840 * window


# ----------------------------------------------------------------------
# The cells rehearsed
# ----------------------------------------------------------------------

def _python(code):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', [FACE])
def test_a_sound_tiny_run_is_correct_and_loads_no_jax(cell):
    got = _python(
        'import json, sys\n'
        'from benchmark import harness\n'
        'from benchmark.tests import test_benchmark_gaze360 as t\n'
        'r = t.measure(%r)\n'
        'print(json.dumps({"correct": r["correct"], "checks": r["checks"],\n'
        '                  "loaded": harness.forbidden_modules()}))\n'
        % cell)
    assert got['loaded'] == []
    assert got['correct'], got['checks']


def test_a_wrong_window_gather_fails_the_face_check(monkeypatch):
    """Windows that wrap around the clip instead of holding to it: the
    clip's first and last three frames read the wrong frames."""
    from eve_tpu_torch.models import gaze360 as port

    def wrapped(T, device=None):
        t = torch.arange(T, device=device)[:, None]
        k = torch.arange(-3, 4, device=device)[None, :]
        return (t + k) % T

    monkeypatch.setattr(port, 'window_indices', wrapped)
    result = measure(FACE, trace=0)
    assert not result['correct']
    assert result['checks']['gaze_deg_mean']['value'] > \
        result['checks']['gaze_deg_mean']['limit']


def test_face_reference_runs_the_backbone_on_every_window_frame():
    """The literal form: 7 backbone passes of B*T frames a batch."""
    B, T, px = 2, 9, 64
    cell = tiny_cell(FACE)
    batch = face_offline.face_batch(
        face_offline.synthetic.rng_for(SEED, 1), B, T, px, 10,
        torch.Generator().manual_seed(1))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()
               if k != 'timestamps'}
    w = face_offline.make_weights(cell, SEED, torch.device('cpu'))
    seen = []
    real = gaze360.backbone

    def counting(weights, x, quant=ref._ident):
        seen.append(x.shape[0])
        return real(weights, x, quant)

    gaze360.backbone = counting
    try:
        with torch.no_grad():
            gaze360.forward(w, cell.config['config'], tensors)
    finally:
        gaze360.backbone = real
    assert seen == [B * T] * 7
