"""The port's regression gate (``eve_tpu_torch.bench.inference.run_check``)
against eve_tpu's (``bench.run_check``), on the CPU.

Every case of ``tests/test_bench_check.py`` runs through both gates with
the same stubbed measurements and the same bands: eve_tpu's with
``CHECKS`` and ``BANDS_FILE`` monkeypatched as that test does, the port's
with ``CHECKS`` monkeypatched and ``bands_path`` in ``tmp_path``. Both
must give the same exit code, the same last JSON line and, after a
record, the same ``recorded`` bands; a breach prints ``PERF REGRESSION``
in both. Then the port's ``CHECKS`` against eve_tpu's, the committed
bands file, the device-time trap and ``main``'s routing.
"""

import json
import os
import sys

import pytest
import torch

from eve_tpu_torch.bench import chain, inference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (eve_tpu's root bench.py)

FPS, MS = ('frames/s', True), ('ms', False)
# name -> (stubbed measurements {metric: (value, unit, higher_is_better)},
# bands file payload, exit code); the cases of tests/test_bench_check.py.
CASES = {
    'in_band': ({'m': (100.0,) + FPS}, {'rel_tol': 0.06,
                                         'recorded': {'m': 101.0}}, 0),
    'slower_throughput_fails': (
        {'m': (90.0,) + FPS}, {'rel_tol': 0.06, 'recorded': {'m': 100.0}},
        1),
    'faster_throughput_never_fails': (
        {'m': (200.0,) + FPS}, {'rel_tol': 0.06, 'recorded': {'m': 100.0}},
        0),
    'slower_latency_fails': (
        {'ms': (120.0,) + MS}, {'rel_tol': 0.06, 'recorded': {'ms': 100.0}},
        1),
    'faster_latency_passes': (
        {'ms': (80.0,) + MS}, {'rel_tol': 0.06, 'recorded': {'ms': 100.0}},
        0),
    'missing_band_fails': (
        {'m': (100.0,) + FPS, 'new_metric': (5.0,) + MS},
        {'rel_tol': 0.06, 'recorded': {'m': 100.0}}, 1),
    'default_tolerance_fails': (
        {'train_ms': (108.0,) + MS},
        {'rel_tol': 0.06, 'recorded': {'train_ms': 100.0}}, 1),
    'per_metric_tolerance_passes': (
        {'train_ms': (108.0,) + MS},
        {'rel_tol': 0.06, 'recorded': {'train_ms': 100.0},
         'per_metric_tol': {'train_ms': 0.10}}, 0),
    'other_metrics_keep_the_default': (
        {'train_ms': (108.0,) + MS, 'other_ms': (108.0,) + MS},
        {'rel_tol': 0.06, 'recorded': {'train_ms': 100.0, 'other_ms': 100.0},
         'per_metric_tol': {'train_ms': 0.10}}, 1),
    'pending_record_does_not_fail': (
        {'m': (100.0,) + FPS, 'new_metric': (5.0,) + MS},
        {'rel_tol': 0.06, 'recorded': {'m': 100.0},
         'pending_record': ['new_metric']}, 0),
}


@pytest.fixture
def gates(monkeypatch, tmp_path, capsys):
    """``run(checks, payload, record) -> [(rc, last line, stderr, bands
    file), ...]`` for eve_tpu's gate and the port's."""
    paths = {'eve_tpu': tmp_path / 'eve_tpu_bands.json',
             'port': tmp_path / 'port_bands.json'}

    def run(checks, payload=None, record=False):
        monkeypatch.setattr(bench, 'CHECKS', {
            name: (lambda v=value: v, unit, higher)
            for name, (value, unit, higher) in checks.items()})
        # os.path.join keeps an absolute BANDS_FILE as it is.
        monkeypatch.setattr(bench, 'BANDS_FILE', str(paths['eve_tpu']))
        monkeypatch.setattr(inference, 'CHECKS', {
            name: (lambda device, v=value: v, unit, higher)
            for name, (value, unit, higher) in checks.items()})
        if payload is not None:
            for path in paths.values():
                path.write_text(json.dumps(payload))
        outs = []
        for which, call in (
                ('eve_tpu', lambda: bench.run_check(record=record)),
                ('port', lambda: inference.run_check(
                    record=record, bands_path=str(paths['port']),
                    device='cpu'))):
            rc = call()
            captured = capsys.readouterr()
            last = json.loads(captured.out.strip().splitlines()[-1])
            outs.append((rc, last, captured.err,
                         json.loads(paths[which].read_text())))
        return outs

    return run


@pytest.mark.parametrize('case', sorted(CASES))
def test_gate_agrees_with_eve_tpus(case, gates):
    checks, payload, want = CASES[case]
    (rc_j, line_j, err_j, _), (rc_t, line_t, err_t, _) = gates(checks,
                                                                payload)
    assert rc_t == rc_j == want
    assert line_t == line_j == {'metric': 'bench_check',
                                'value': 1 - want, 'unit': 'pass',
                                'vs_baseline': 0}
    assert ('PERF REGRESSION' in err_t) == ('PERF REGRESSION' in err_j) == (
        want == 1)


def test_record_round_trips_as_eve_tpus(gates):
    checks = {'m': (123.45,) + FPS, 'ms': (6.789,) + MS}
    (rc_j, line_j, _, bands_j), (rc_t, line_t, _, bands_t) = gates(
        checks, record=True)
    assert rc_t == rc_j == 0
    assert line_t == line_j == {'metric': 'bench_check', 'value': 1,
                                'unit': 'recorded', 'vs_baseline': 0}
    assert bands_t['recorded'] == bands_j['recorded'] == {'m': 123.45,
                                                          'ms': 6.79}
    assert set(bands_t) == set(bands_j) | {'card'}
    assert bands_t['card'] == 'cpu'
    assert bands_t['rel_tol'] == bands_j['rel_tol'] == 0.06
    # Each gate then passes against its own record.
    for rc, line, _, _ in gates(checks):
        assert rc == 0 and line['value'] == 1


def test_checks_are_eve_tpus_metrics():
    """The same names in the same order, units and directions."""
    assert list(inference.CHECKS) == list(bench.CHECKS)
    for name, (_, unit, higher) in bench.CHECKS.items():
        assert inference.CHECKS[name][1:] == (unit, higher), name
    assert inference.REL_TOL == bench.REL_TOL
    for name, tol in inference.PER_METRIC_TOL.items():
        assert name in inference.CHECKS
        assert tol >= bench.PER_METRIC_TOL.get(name, bench.REL_TOL)


def test_committed_bands_cover_every_check_and_name_the_card():
    with open(inference.BANDS_FILE) as f:
        bands = json.load(f)
    assert os.path.dirname(inference.BANDS_FILE) == os.path.dirname(
        inference.__file__)
    assert set(bands['recorded']) == set(inference.CHECKS)
    assert not bands.get('pending_record')
    assert all(v > 0 for v in bands['recorded'].values())
    assert bands['card'].startswith('NVIDIA ') and ' W' in bands['card']
    assert bands['card'] in bands['note']
    assert bands['rel_tol'] == inference.REL_TOL
    assert bands['per_metric_tol'] == inference.PER_METRIC_TOL


def test_a_missing_device_time_raises(monkeypatch):
    """Off a card ``measure_device_ms`` has no device time; the gate
    raises and never takes the chained wall in its place."""
    monkeypatch.setattr(chain, 'measure_device_ms', lambda **kw: {
        'device_ms': None, 'chained_wall_ms': 12.5})
    for name in ('inference_device_ms', 'latency_b1_device_ms_tpu_native'):
        with pytest.raises(RuntimeError, match='no device time on cpu'):
            inference.CHECKS[name][0]('cpu')
    monkeypatch.setattr(chain, 'measure_device_ms', lambda **kw: {
        'device_ms': 7.0, 'chained_wall_ms': 12.5})
    assert inference.CHECKS['inference_device_ms'][0]('cpu') == 7.0


def test_the_gates_bf16_inference_replays_graphs(monkeypatch):
    """The gate's ``inference_frames_per_sec`` times CUDA-graph replays of
    the forward; the native topology's metric times eager calls."""
    calls = []
    monkeypatch.setattr(inference, 'measure_inference',
                        lambda **kw: calls.append(kw) or 1.0)
    for name in ('inference_frames_per_sec',
                 'inference_frames_per_sec_tpu_native'):
        assert inference.CHECKS[name][0]('cpu') == 1.0
    assert calls == [{'device': 'cpu', 'graph': True},
                     {'tpu_native': True, 'device': 'cpu'}]


@pytest.mark.parametrize('flag', ['--check', '--record'])
def test_main_routes_the_gate_flags(flag, monkeypatch):
    calls = []
    monkeypatch.setattr(inference, 'run_check', lambda **kw: calls.append(
        kw) or 1)
    assert inference.main(['--device', 'cpu', flag]) == 1
    assert calls == [{'record': flag == '--record', 'device': 'cpu'}]


def test_the_gate_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card is visible'):
        inference.run_check(bands_path=str(tmp_path / 'bands.json'))
