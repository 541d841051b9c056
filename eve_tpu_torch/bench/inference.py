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
ported. eve_tpu's ``--check`` and ``--record`` gate on bands of TPU
numbers (``bench_bands.json``); here they exit non-zero.

``measure_train_step_ms`` is eve_tpu's ``measure_train_step_ms``: the
train step (forward, backward, clip, Adam) at B = 8, T = 30 through the
port's ``train_step``, on eve_tpu's bench config: the defaults with
RefineNet and screen content on, so the EyeNet trains too (unlike
``configs/refine_net.json``, which freezes it).
"""

import argparse
import sys
import time

import numpy as np
import torch

from eve_tpu_torch.bench import common


def measure_inference(batch_size=16, seq=30, iters=20, dtype='bfloat16',
                      input_dtype='uint8', tpu_native=False,
                      stem='patchify', device='cuda', eyes=common.EYES):
    """Inference frames/s with device-resident inputs: each variant warmed
    once, then ``iters`` forwards that cycle them, synchronised at both
    ends."""
    device = common.resolve_device(device)
    spec = common.flagship_spec(dtype, tpu_native, stem)
    model = common.init_flagship(spec, device).eval()
    batches = common.make_batches(batch_size, seq, device, eyes, input_dtype)
    with torch.inference_mode():
        for b in batches:
            common.infer(model, b)
        common.sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            common.infer(model, batches[i % len(batches)])
        common.sync(device)
        elapsed = time.perf_counter() - t0
    return batch_size * seq * iters / elapsed


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
                        help='eve_tpu\'s regression gate; exits non-zero: '
                             'its bands are TPU numbers')
    parser.add_argument('--record', action='store_true',
                        help='eve_tpu\'s band recorder; exits non-zero: its '
                             'bands are TPU numbers')
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
        common.note('--check/--record gate on eve_tpu\'s bench_bands.json, '
                    'which holds TPU numbers; the port has no bands of its '
                    'own')
        return 2

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
