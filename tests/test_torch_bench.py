"""The measuring tools (``eve_tpu_torch.bench``) against eve_tpu's, on the CPU.

- The bench's batches are eve_tpu's ``make_synthetic_batch`` sequence,
  bitwise.
- The bench's forward (``common.infer`` on the bench's batch variant 0)
  returns eve_tpu's four bench outputs with the same weights (converted
  with ``utils.convert``) at ``test_torch_eve.py``'s tolerances: PoG px
  rtol 1e-4, atol 1e-2; everything else rtol 1e-4, atol 1e-4.
- Each tool's ``main`` at a tiny size (eyes 32, B = 2, T = 2) prints one
  JSON line with eve_tpu's keys plus the stated additions.
- The checkpoint tool's ``params`` is eve_tpu's parameter count; the phase
  tool's ``eye_features`` GFLOP is ResNet-18's convolutions and the
  EyeNet's linear layers, counted by hand; the heatmap ops' formulas and
  the operand-byte count on single ops.
- ``--device cuda`` without a card raises. The regression gate
  (``--check``/``--record``) is held in ``test_torch_bench_gate.py``.
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest

import jax
import torch

from eve_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eve_tpu.models import eve as jeve
from eve_tpu_torch.bench import (
    chain, checkpoint, common, inference, phases, serve)
from eve_tpu_torch.kernels import heatmap_kernels as hk
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.utils import convert

# Every tool at a tiny size on the CPU.
TINY = ['--device', 'cpu', '--eyes', '32', '--batch', '2', '--seq', '2']
# Parity: 48x48 eyes (at 32x32 ResNet-18's layer4 is 1x1).
EYE, B, T = 48, 2, 2


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_main(main, argv):
    """``main(argv)``'s exit code and its stdout's one JSON line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


@pytest.mark.parametrize('input_dtype', ['uint8', 'float32'])
def test_variants_are_eve_tpus_batches(input_dtype):
    """Bitwise, but for the gaze labels: each package derives them with
    its own float32 geometry (torch and XLA), up to 1.2e-7 rad apart."""
    ours = common.make_batches(B, T, torch.device('cpu'), eyes=32,
                               input_dtype=input_dtype)
    rng = np.random.RandomState(0)
    frame = np.uint8 if input_dtype == 'uint8' else np.float32
    assert len(ours) == common.N_VARIANTS == 4
    for got in ours:
        want = jax_batch(rng, batch_size=B, sequence_len=T, eyes_size=32,
                         frame_dtype=frame)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].numpy().dtype == v.dtype, k
            if k.endswith('_g_tobii'):
                np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                           atol=1.2e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _weights(tree, rng):
    """Every leaf of eve_tpu's parameter tree drawn from ``rng``, so no
    head is zero: kernels at 1/sqrt(fan-in), norm scales near 1, biases
    small."""
    def leaf(path, s):
        name = path[-1].key
        if len(s.shape) >= 2:
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])),
                           s.shape)
        elif name == 'scale':
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            v = 0.05 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope='module')
def flagship():
    """eve_tpu's bench spec at float32, seeded weights for both packages,
    and the port's model holding them."""
    jspec = jeve.EveSpec(refine_net_enabled=True, load_screen_content=True,
                         compute_dtype='float32')
    shapes = jax.eval_shape(functools.partial(jeve.init_params, jspec),
                            jax.random.PRNGKey(0))
    params = _weights(shapes, np.random.RandomState(0))
    # A flatter refined heatmap (the soft-argmax scales its differences by
    # up to beta * 1920 px) and a pupil head that passes its ReLU.
    params['refine_net']['final_2']['kernel'] *= 0.1
    params['eye_net']['fc_to_pupil_2']['bias'] += 1.0
    model = teve.build_model(common.flagship_spec('float32'),
                             convert.eve_state_dict(params), 'cpu')
    return jspec, params, shapes, model


@pytest.mark.parametrize('input_dtype', ['uint8', 'float32'])
def test_bench_forward_matches_eve_tpus_bench_infer(flagship, input_dtype):
    jspec, params, _, model = flagship
    batch = common.make_batches(B, T, torch.device('cpu'), eyes=EYE,
                                input_dtype=input_dtype, n=1)[0]
    with torch.inference_mode():
        ours = common.infer(model, batch)

    @jax.jit
    def infer(params, batch):
        out = jeve.forward(jspec, params, batch, training=False,
                           output_predictions=True)
        return tuple(out[k] for k in common.INFER_OUTPUTS)

    want = infer(params, {k: v.numpy() for k, v in batch.items()})
    # Every output is live: the PoGs vary, the pupils pass their ReLU.
    assert min(np.ptp(np.asarray(w)) for w in want[:2]) > 1.0
    assert min(float(np.asarray(w).min()) for w in want[2:]) > 0.0
    for key, got, ref in zip(common.INFER_OUTPUTS, ours, want):
        tol = (dict(rtol=1e-4, atol=1e-2) if 'PoG_px' in key
               else dict(rtol=1e-4, atol=1e-4))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=key, **tol)


def test_checkpoint_params_are_eve_tpus_count(flagship):
    _, _, shapes, _ = flagship
    rc, line = run_main(checkpoint.main, ['--device', 'cpu', '--reps', '1'])
    assert rc == 0
    assert set(line) == {'metric', 'value', 'unit', 'sync_blocked_s',
                         'async_blocked_s', 'async_bg_write_s', 'params',
                         'refine', 'card'}
    assert line['metric'] == 'checkpoint_save_blocked_seconds'
    assert line['params'] == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert line['refine'] is True and line['card'] == 'cpu'
    assert line['value'] == line['async_blocked_s'] >= 0


@pytest.mark.parametrize('extra,metric,native_key', [
    ([], 'eve_full_inference_frames_per_sec_per_chip', True),
    (['--tpu-native-arch'],
     'eve_full_inference_frames_per_sec_per_chip_tpu_native', False),
    (['--no-tpu-native', '--pallas', '--no-baseline'],
     'eve_full_inference_frames_per_sec_per_chip', False),
], ids=['default', 'native', 'no-native'])
def test_inference_main_prints_eve_tpus_line(extra, metric, native_key):
    rc, line = run_main(inference.main, TINY + ['--iters', '1'] + extra)
    assert rc == 0
    keys = {'metric', 'value', 'unit', 'vs_baseline', 'card'}
    if native_key:
        keys.add('tpu_native_arch_frames_per_sec')
        assert line['tpu_native_arch_frames_per_sec'] > 0
    assert set(line) == keys
    assert line['metric'] == metric and line['unit'] == 'frames/s'
    assert line['value'] > 0 and line['vs_baseline'] == 0.0
    assert line['card'] == 'cpu'


def test_train_step_ms_runs_eve_tpus_step():
    ms = inference.measure_train_step_ms(batch_size=1, seq=1, iters=1,
                                         device='cpu', eyes=32, repeats=1)
    assert np.isfinite(ms) and ms > 0


def test_chain_main_prints_eve_tpus_line():
    rc, line = run_main(chain.main, TINY + [
        '--k1', '0', '--k2', '1', '--b1-k1', '0', '--b1-k2', '1'])
    assert rc == 0
    assert set(line) == {'metric', 'value', 'unit', 'frames_per_sec',
                         'batch', 'seq', 'tpu_native_arch', 'vs_baseline',
                         'chained_wall_ms', 'latency_b1', 'card'}
    assert line['metric'] == 'eve_inference_device_ms_per_batch'
    # A device time is a card's: on the CPU it is not measured.
    assert line['value'] is None and line['frames_per_sec'] is None
    assert line['chained_wall_ms'] > 0
    assert line['latency_b1']['device_ms'] is None
    assert line['latency_b1']['chained_wall_ms'] > 0
    assert (line['batch'], line['seq']) == (2, 2)


def test_device_ms_alone_times_no_chain():
    # The gate's call: the chained wall is not measured, and off a card
    # there is no device time either.
    assert chain.measure_device_ms(batch_size=1, seq=2, k1=0, k2=1,
                                   device='cpu', eyes=32, wall=False) == {
        'device_ms': None, 'chained_wall_ms': None}


SERVE_KEYS = {'metric', 'value', 'unit', 'sessions', 'chunk_frames',
              'max_batch', 'chunk_p50_ms', 'chunk_p95_ms', 'batches',
              'requests', 'tpu_native_arch', 'num_devices', 'card'}
LOOPBACK_KEYS = {'raw_step_ms', 'roundtrip_step_ms', 'engine_batch_ms',
                 'batcher_overhead_ms', 'host_batcher_ms'}


@pytest.mark.parametrize('extra', [[], ['--loopback'],
                                   ['--num-devices', '2']],
                         ids=['sustained', 'loopback', 'two-replicas'])
def test_serve_main_prints_eve_tpus_line(extra):
    sessions, chunks = 2, 2
    rc, line = run_main(serve.main, [
        '--device', 'cpu', '--eyes', '32', '--seq', '1', '--max-batch', '2',
        '--distinct', '2', '--sessions', str(sessions), '--chunks',
        str(chunks)] + extra)
    assert rc == 0
    loopback = '--loopback' in extra
    assert set(line) == SERVE_KEYS | (LOOPBACK_KEYS if loopback else set())
    assert line['metric'] == ('serve_loopback_frames_per_sec' if loopback
                              else 'serve_sustained_frames_per_sec')
    # The timed chunks and the warm-up request.
    assert line['requests'] == sessions * chunks + 1
    assert 1 <= line['batches'] <= line['requests']
    assert line['value'] > 0
    assert line['chunk_p50_ms'] <= line['chunk_p95_ms']
    if loopback:
        assert np.isfinite(line['host_batcher_ms'])
        assert line['host_batcher_ms'] >= 0
        assert line['raw_step_ms'] > 0 and line['roundtrip_step_ms'] > 0


def test_host_batcher_ms_is_finite():
    ms = serve.measure_host_batcher_ms(sessions=2, chunks=2, seq=1,
                                       max_batch=2, eyes=32, device='cpu')
    assert np.isfinite(ms) and ms >= 0


def _eye_features_flops(n, eyes):
    """ResNet-18/IN (7x7/2 stem, 3x3/2 max-pool, 2 basic blocks a stage,
    1x1/2 downsampling) and the EyeNet's linear layers on n patches:
    2 * Cin * Cout * k^2 * Hout * Wout a convolution, 2 * in * out a
    linear layer, a patch."""
    def out(size, k, stride, pad):
        return (size + 2 * pad - k) // stride + 1

    def conv(cin, cout, k, size):
        return 2 * cin * cout * k * k * size * size

    size = out(eyes, 7, 2, 3)
    flops = conv(3, 64, 7, size)
    size = out(size, 3, 2, 1)                       # max-pool
    cin = 64
    for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        out_size = out(size, 3, stride, 1)
        flops += conv(cin, cout, 3, out_size)       # block 1, conv1
        flops += conv(cout, cout, 3, out_size)      # block 1, conv2
        if stride != 1:
            flops += conv(cin, cout, 1, out_size)   # downsample
        flops += 2 * conv(cout, cout, 3, out_size)  # block 2
        size, cin = out_size, cout
    flops += 2 * 512 * 128                          # cnn fc
    flops += 2 * 130 * 128 + 2 * 128 * 128          # fc_common
    return n * flops


def test_phases_infer_main_counts_resnet_flops():
    rc, line = run_main(phases.main, TINY + ['--mode', 'infer',
                                             '--iters', '1'])
    assert rc == 0
    assert set(line) == {'metric', 'value', 'unit', 'frames',
                         'tpu_native_arch', 'phases', 'card'}
    assert line['metric'] == 'eve_inference_phase_breakdown'
    rows = {r['phase']: r for r in line['phases']}
    assert list(rows) == ['eye_features', 'eye_only', 'full']
    for r in rows.values():
        assert set(r) == {'phase', 'ms', 'gflop', 'gb_op_operands',
                          'gb_op_operands_per_s'}
        assert r['ms'] > 0 and r['gb_op_operands'] > 0
    assert line['value'] == rows['full']['ms']
    want = _eye_features_flops(2 * 2 * 2, 32) / 1e9
    assert rows['eye_features']['gflop'] == pytest.approx(want, rel=1e-12)
    assert (rows['eye_features']['gflop'] < rows['eye_only']['gflop']
            < rows['full']['gflop'])


def test_phases_train_main_prints_eve_tpus_line():
    # The eye-only model at one frame (the flagship's step runs in
    # test_train_step_ms_runs_eve_tpus_step, its forward's counts in
    # test_phases_infer_main_counts_resnet_flops; --remat-sweep runs on the
    # card, in chip_smoke.py's bench phase). 48x48 eyes: at 32x32
    # ResNet-18's layer4 is 1x1, where the instance norm's output is 0 and
    # no gradient reaches the convolutions.
    rc, line = run_main(phases.main, TINY + [
        '--mode', 'train', '--iters', '1', '--no-refine', '--eyes', '48',
        '--batch', '1', '--seq', '1', '--dtype', 'float32'])
    assert rc == 0
    assert set(line) == {'metric', 'value', 'unit', 'frames_per_sec',
                         'batch', 'seq', 'dtype', 'refine',
                         'tpu_native_arch', 'tpu_native_stem', 'phases',
                         'card'}
    assert line['metric'] == 'eve_train_step_ms'
    assert line['refine'] is False and line['dtype'] == 'float32'
    rows = {r['phase']: r for r in line['phases']}
    assert list(rows) == ['fwd', 'fwd_bwd', 'full_step']
    assert line['value'] == round(rows['full_step']['ms'], 2)
    # The backward adds the convolutions' two gradient products (the
    # stem's input gradient excepted); clip and Adam add no product.
    assert 2.5 * rows['fwd']['gflop'] < rows['fwd_bwd']['gflop'] < (
        3 * rows['fwd']['gflop'])
    assert rows['full_step']['gflop'] == rows['fwd_bwd']['gflop']
    assert rows['fwd']['gb_op_operands'] < rows['fwd_bwd']['gb_op_operands']


def test_heatmap_op_formulas_and_operand_bytes():
    c = torch.rand(5, 2) * 1000
    mask = torch.ones(5)
    gflop, gb = phases.count_work(lambda: hk.render_heatmaps(
        c, (10.0, 3.0, 5.0), mask))
    assert gflop * 1e9 == 3 * 5 * (72 * 128 * 5 + 2 * (72 + 128))
    # The op's operands and result: the CPU plain version's own ops are
    # not the dispatched op's.
    assert gb * 1e9 == (5 * 2 + 5 + 3 * 5 * 72 * 128) * 4
    x = torch.rand(7, 72, 128)
    gflop, _ = phases.count_work(lambda: hk.soft_argmax(x))
    assert gflop * 1e9 == 7 * 72 * 128 // 4 * 29
    a, b = torch.ones(3, 4), torch.ones(3, 4)
    assert phases.count_work(lambda: (a + b).view(12))[1] * 1e9 == 3 * 48


@pytest.mark.parametrize('call', [
    lambda: inference.measure_inference(device='cuda'),
    lambda: inference.measure_train_step_ms(device='cuda'),
    lambda: chain.measure_device_ms(device='cuda'),
    lambda: serve.measure_serving(device='cuda'),
    lambda: serve.measure_host_batcher_ms(device='cuda'),
    lambda: checkpoint.measure_checkpoint(device='cuda'),
    lambda: phases.train_phases(device='cuda'),
    lambda: phases.infer_phases(device='cuda'),
], ids=['inference', 'train_step', 'chain', 'serve', 'host_batcher',
        'checkpoint', 'phases_train', 'phases_infer'])
def test_cuda_without_a_card_raises(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card is visible'):
        call()


def test_device_busy_is_the_union_of_intervals():
    # Two overlapping kernels on two streams count once; a gap counts not.
    assert common.union_ms([(0.0, 1000.0), (500.0, 1500.0),
                            (3000.0, 3500.0), (3100.0, 3200.0)]) == 2.0
    assert common.union_ms([]) == 0.0
    with pytest.raises(ValueError, match='on a card'):
        common.device_busy_ms(lambda: None, torch.device('cpu'), 1)


def test_raw_events_are_the_profilers_own():
    """The busy time reads the tracer's raw events: on the CPU profiler
    they carry the device type and the ns bounds it reads, and a profiler
    without them raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = list(common.raw_events(prof))
    assert events
    for e in events:
        assert e.device_type() == DeviceType.CPU
        assert 0 < e.start_ns() <= e.end_ns()
    with pytest.raises(RuntimeError, match='kineto_results'):
        common.raw_events(object())
