"""Inference frames/s of the flagship model, and the fused train step's ms.

The counterpart of eve_tpu's ``bench.py``:

    python -m eve_tpu_torch.bench.inference [--device cuda|cpu]

prints one JSON line,
``{"metric": "eve_full_inference_frames_per_sec_per_chip", "value": N,
"unit": "frames/s", "vs_baseline": 0.0, "tpu_native_arch_frames_per_sec":
N, "card": "..."}``.

The workload is eve_tpu's (``common``): the flagship model at B = 16,
T = 30, bf16 compute, uint8 frames already on the device, 4 distinct
batches cycled. Each forward returns ``common.INFER_OUTPUTS``. The default
run also measures the opt-in topology (``tpu_native_arch``) and adds it as
``tpu_native_arch_frames_per_sec``; under ``--tpu-native-arch`` the metric
is ``eve_full_inference_frames_per_sec_per_chip_tpu_native``.

``vs_baseline`` is 0.0, as under eve_tpu's ``--no-baseline``: eve_tpu's
baseline is a reference-style per-timestep loop timed on its bench host's
CPU (``bench_baseline.py``), which says nothing of a card; it is not
ported.

The performance regression gate is eve_tpu's, on bands of the port's own
(``BANDS_FILE`` beside this module, recorded on a card; eve_tpu's root
``bench_bands.json`` holds TPU numbers and is never read):

    python -m eve_tpu_torch.bench.inference --check    # exit 1 on a breach
    python -m eve_tpu_torch.bench.inference --record   # rewrite the bands

``run_check`` measures every metric of ``CHECKS`` (eve_tpu's 11 names,
units and directions, each on the port's measuring function at eve_tpu's
defaults) and holds each against its recorded value: a band of
``rel_tol`` (or the metric's ``per_metric_tol``) either side, of which
only the bad side fails; a metric without a band fails unless it is
listed under ``pending_record``. ``--record`` writes the bands with the
card's ``nvidia-smi`` line under ``card``. The device-ms metrics are
``chain.measure_device_ms``'s profiler time, which exists on a card only:
the gate raises without it and never takes the chained wall in its place.

The gate's ``inference_frames_per_sec`` times CUDA-graph replays of the
forward (``measure_inference(graph=True)``), so that it follows the card
as eve_tpu's compiled forward does: eagerly, the bf16 forward's host
launches take longer than its device work, and the host's clock spreads
by a quarter within one process. The other host-clock metrics time eager
calls.

``measure_train_step_ms`` is eve_tpu's ``measure_train_step_ms``: the
train step (forward, backward, clip, Adam) at B = 8, T = 30 through the
port's ``train_step``, on eve_tpu's bench config: the defaults with
RefineNet and screen content on, so the EyeNet trains too (unlike
``configs/refine_net.json``, which freezes it).
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from eve_tpu_torch.bench import chain, common, serve

BANDS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'bench_bands.json')
REL_TOL = 0.06
# Per-metric tolerance overrides: eve_tpu's (0.10 for the train steps,
# 0.30 for the batcher), widened to 1.5x the largest spread seen on one
# H100 within each regime a check compares in: separate gate processes
# (a --check against the committed record), and chip_smoke.py's record
# and check in one long process (PERF.md, the gate's bands). The
# host-clock metrics of host-bound work (native bf16 inference, the train
# steps, the batcher) spread by 21.7-94.0% between processes there, so
# their bands catch only gross regressions; the device ms by 1.4-7.2%.
PER_METRIC_TOL = {
    'inference_frames_per_sec': 0.10,
    'inference_frames_per_sec_tpu_native': 0.53,
    'train_step_ms': 0.53,
    'train_step_ms_tpu_native': 1.05,
    'train_step_ms_patchify8': 1.29,
    'latency_b1_device_ms': 0.11,
    'serve_host_batcher_ms': 1.41,
}


def measure_inference(batch_size=16, seq=30, iters=20, dtype='bfloat16',
                      input_dtype='uint8', tpu_native=False,
                      stem='patchify', device='cuda', eyes=common.EYES,
                      graph=False):
    """Inference frames/s with device-resident inputs: each variant warmed
    once, then ``iters`` forwards that cycle them, synchronised at both
    ends. ``graph`` (a card only): each variant's forward is captured once
    as a CUDA graph after its warm-up, and the timed forwards replay the
    graphs, so that the time is the card's work and not the host's
    launches (eve_tpu times a compiled forward)."""
    device = common.resolve_device(device)
    spec = common.flagship_spec(dtype, tpu_native, stem)
    model = common.init_flagship(spec, device).eval()
    batches = common.make_batches(batch_size, seq, device, eyes, input_dtype)
    forwards = [functools.partial(common.infer, model, b) for b in batches]
    with torch.inference_mode():
        if graph and device.type == 'cuda':
            forwards = [g.replay for g in _captured(forwards, device)]
        else:
            for forward in forwards:
                forward()
        common.sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            forwards[i % len(forwards)]()
        common.sync(device)
        elapsed = time.perf_counter() - t0
    return batch_size * seq * iters / elapsed


def _captured(forwards, device):
    """A CUDA graph of each call in ``forwards``, each warmed once on a
    side stream first (cuDNN's choices and the layers' cached casts are
    made outside the capture); the graphs share one memory pool, as they
    replay one after another on one stream and their outputs are not
    read."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for forward in forwards:
            forward()
    torch.cuda.current_stream(device).wait_stream(side)
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for forward in forwards:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool):
            forward()
        graphs.append(g)
    return graphs


def measure_train_step_ms(batch_size=8, seq=30, iters=10, dtype='bfloat16',
                          tpu_native=False, stem='patchify', device='cuda',
                          eyes=common.EYES, repeats=3):
    """ms a train step (forward, backward, clip, Adam): 2 warm-up steps,
    then the median of ``repeats`` timed runs of ``iters`` steps, each step
    with its own seeded kappa generator, as eve_tpu times its step."""
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import step as step_lib

    device = common.resolve_device(device)
    # eve_tpu's bench config: the defaults with RefineNet and screen content.
    config = Config()
    config.import_dict({'refine_net_enabled': True,
                        'load_screen_content': True,
                        'batch_size': batch_size,
                        'tpu_compute_dtype': dtype,
                        'tpu_native_arch': tpu_native,
                        'tpu_native_stem': stem})
    model = common.init_flagship(eve_lib.EveSpec.from_config(config), device)
    state = step_lib.create_train_state(config, model, 1000)
    batches = common.make_batches(batch_size, seq, device, eyes, n=2)
    key = iter(range(repeats * iters + 2))

    def step(batch):
        return step_lib.train_step(state, batch,
                                   torch.Generator().manual_seed(next(key)))

    for i in range(2):
        step(batches[i % 2])
    common.sync(device)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            step(batches[i % 2])
        common.sync(device)
        samples.append((time.perf_counter() - t0) / iters * 1e3)
    return float(np.median(samples))


def device_ms(device, **kw):
    """``chain.measure_device_ms``'s device-busy ms a forward (its chained
    wall not measured); raises where there is none (off a card): the
    chained wall is not a device time."""
    ms = chain.measure_device_ms(device=device, wall=False,
                                 **kw)['device_ms']
    if ms is None:
        raise RuntimeError('no device time on %s: the gate\'s device-ms '
                           'metrics are measured on a card only' % device)
    return ms


# Checked metrics: name -> (measure_fn(device), unit, higher_is_better),
# eve_tpu's names in eve_tpu's order. The *_frames_per_sec and
# train_step_ms* metrics are host-clock timings of dispatched work; the
# *_device_ms metrics are the profiler's device-busy time.
CHECKS = {
    'inference_frames_per_sec': (
        lambda device: measure_inference(device=device, graph=True),
        'frames/s', True),
    'inference_frames_per_sec_tpu_native': (
        lambda device: measure_inference(tpu_native=True, device=device),
        'frames/s', True),
    'train_step_ms': (
        lambda device: measure_train_step_ms(device=device), 'ms', False),
    'train_step_ms_tpu_native': (
        lambda device: measure_train_step_ms(tpu_native=True, device=device),
        'ms', False),
    'train_step_ms_patchify8': (
        lambda device: measure_train_step_ms(tpu_native=True,
                                             stem='patchify8', device=device),
        'ms', False),
    'inference_device_ms': (
        lambda device: device_ms(device), 'ms', False),
    'inference_device_ms_tpu_native': (
        lambda device: device_ms(device, tpu_native=True), 'ms', False),
    'inference_device_ms_patchify8': (
        lambda device: device_ms(device, tpu_native=True, stem='patchify8'),
        'ms', False),
    'latency_b1_device_ms': (
        lambda device: device_ms(device, batch_size=1, k1=4, k2=44),
        'ms', False),
    'latency_b1_device_ms_tpu_native': (
        lambda device: device_ms(device, batch_size=1, k1=4, k2=44,
                                 tpu_native=True), 'ms', False),
    'serve_host_batcher_ms': (
        lambda device: serve.measure_host_batcher_ms(device=device),
        'ms', False),
}


def run_check(record=False, bands_path=None, device='cuda'):
    """eve_tpu's ``bench.py --check`` (``record``: ``--record``) on the
    bands at ``bands_path`` (default ``BANDS_FILE``); returns the exit
    code. Prints a table on stderr and the ``bench_check`` line on
    stdout."""
    bands_path = bands_path or BANDS_FILE
    results = {}
    for name, (fn, unit, _) in CHECKS.items():
        v = fn(device)
        results[name] = round(v, 2)
        print('%-42s %10.2f %s' % (name, v, unit), file=sys.stderr)

    if record:
        card = common.card_line(torch.device(device))
        with open(bands_path, 'w') as f:
            json.dump({'rel_tol': REL_TOL, 'per_metric_tol': PER_METRIC_TOL,
                       'recorded': results,
                       'card': card,
                       'note': 'eve_tpu_torch.bench.inference --check '
                               'bands, recorded on %s; per_metric_tol '
                               'covers 1.5x the largest spread the gate\'s '
                               'runs on an H100 had shown before this '
                               'record (PERF.md). Update with --record '
                               'after intentional perf changes.' % card},
                      f, indent=1)
        print('recorded bands -> %s' % bands_path, file=sys.stderr)
        print(json.dumps({'metric': 'bench_check', 'value': 1,
                          'unit': 'recorded', 'vs_baseline': 0}))
        return 0

    with open(bands_path) as f:
        bands = json.load(f)
    if 'card' in bands:
        common.note('bands recorded on %s' % bands['card'])
    default_tol = bands.get('rel_tol', REL_TOL)
    per_metric = bands.get('per_metric_tol', {})
    # A metric listed as pending_record is measured and reported but does
    # not gate until it is first recorded; an unlisted missing band fails.
    pending = set(bands.get('pending_record', []))
    failures = []
    for name, v in results.items():
        rec = bands['recorded'].get(name)
        if rec is None:
            if name in pending:
                print('%-42s %10.2f (pending first --record)' % (name, v),
                      file=sys.stderr)
                continue
            failures.append('%s: no recorded band' % name)
            continue
        tol = per_metric.get(name, default_tol)
        lo, hi = rec * (1 - tol), rec * (1 + tol)
        _, unit, higher_better = CHECKS[name]
        # Only a breach on the bad side fails: faster is never a
        # regression (re-record so the band follows the new level).
        bad = v < lo if higher_better else v > hi
        status = 'FAIL' if bad else 'ok'
        print('%-42s %10.2f vs [%.2f, %.2f] %s  %s'
              % (name, v, lo, hi, unit, status), file=sys.stderr)
        if bad:
            failures.append('%s: %.2f outside [%.2f, %.2f] %s'
                            % (name, v, lo, hi, unit))
    print(json.dumps({'metric': 'bench_check',
                      'value': 0 if failures else 1,
                      'unit': 'pass', 'vs_baseline': 0}))
    if failures:
        print('PERF REGRESSION: %s' % '; '.join(failures), file=sys.stderr)
        return 1
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--seq', type=int, default=30)
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--eyes', type=int, default=common.EYES,
                        help='eye patch size (eve_tpu fixes 128)')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default cuda; raises without a '
                             'card)')
    parser.add_argument('--pallas', action='store_true',
                        help='accepted for eve_tpu\'s command lines; changes '
                             'nothing: on a CUDA tensor the port always '
                             'launches its heatmap kernels (eve_tpu\'s '
                             'default ran its XLA formulation, not its '
                             'Pallas kernels)')
    parser.add_argument('--no-pallas', action='store_true',
                        help='accepted; changes nothing (see --pallas)')
    parser.add_argument('--tpu-native-stem', default='patchify',
                        choices=['patchify', 'patchify8'],
                        help='EyeNet stem of the opt-in topology')
    parser.add_argument('--tpu-native-arch', action='store_true',
                        help='measure the opt-in topology (patchify stem, '
                             'RefineNetTPU) instead of the reference one')
    parser.add_argument('--check', action='store_true',
                        help='perf regression gate: measure every metric of '
                             'CHECKS on --device at eve_tpu\'s defaults and '
                             'exit 1 on a breach of its band in BANDS_FILE')
    parser.add_argument('--record', action='store_true',
                        help='measure every metric of CHECKS and (over)write '
                             'BANDS_FILE')
    parser.add_argument('--no-baseline', action='store_true',
                        help='accepted; vs_baseline is always 0.0')
    parser.add_argument('--no-tpu-native', action='store_true',
                        help='skip the extra opt-in-topology measurement')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--input-dtype', default='uint8',
                        choices=['float32', 'uint8'],
                        help='uint8 = raw frames scaled on the device')
    args = parser.parse_args(argv)

    if args.check or args.record:
        return run_check(record=args.record, device=args.device)

    kw = dict(batch_size=args.batch, seq=args.seq, iters=args.iters,
              dtype=args.dtype, input_dtype=args.input_dtype,
              device=args.device, eyes=args.eyes)
    fps = measure_inference(tpu_native=args.tpu_native_arch,
                            stem=args.tpu_native_stem, **kw)
    line = {
        'metric': 'eve_full_inference_frames_per_sec_per_chip',
        'value': round(fps, 2),
        'unit': 'frames/s',
        'vs_baseline': 0.0,
    }
    if args.tpu_native_arch:
        line['metric'] += '_tpu_native'
    elif not args.no_tpu_native:
        line['tpu_native_arch_frames_per_sec'] = round(
            measure_inference(tpu_native=True, **kw), 2)
    common.emit(line, torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
