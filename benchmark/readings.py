"""Readings that set the two ends of each limit of ``correct`` in the face
cell: the sound program's and the control's.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \\
        [--sound-only]

At each seed, on the inputs and weights a run of that seed makes, at the
cell's own size:

- ``sound``: the program's numbers as a run compares them, without the
  timed window (every distinct batch once);
- ``control``: the reference put in the program's place with float8 e4m3
  operands in its convolutions (``reference.precision.fp8``), one step
  below the configuration's bfloat16.

Each seed prints one JSON line. The benchmark's own runs never run this.
"""

import argparse
import json

import torch

from benchmark import harness
from benchmark.reference import precision
from benchmark.traffic import face_offline


def face_readings(cell, seed, device, sound_only):
    p = cell.params
    cfg = cell.config['config']
    weights = face_offline.make_weights(cell, seed, device)
    batches = face_offline.make_batches(cell, seed, device)
    want = [face_offline.reference_batch(cfg, weights, b, device,
                                         p['check_block_clips'])
            for b in batches]
    from eve_tpu_torch import infer
    model = face_offline.build_program(cell, weights, device)
    pairs = {}
    for (_, _, got), ref_out in zip(
            infer.iterator(model, batches, create_images=False,
                           materialize_inputs=False), want):
        face_offline.collect(pairs, got, ref_out)
    del model
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    out = {}
    out['sound'], out['sound_gaps'] = _judged(pairs, cell)
    if not sound_only:
        pairs = {}
        for b, ref_out in zip(batches, want):
            face_offline.collect(pairs, face_offline.reference_batch(
                cfg, weights, b, device, p['check_block_clips'],
                quant=precision.fp8), ref_out)
        out['control'], out['control_gaps'] = _judged(pairs, cell)
    return out


def _judged(pairs, cell):
    checks, info = face_offline.judged(pairs, cell.limits)
    return {name: value for name, value, _ in checks}, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--sound-only', action='store_true')
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_devices(cell.chips)
    harness.pin_host()
    device = torch.device('cuda', 0)
    # As a run: float32 means float32, without TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if cell.params['kind'] != 'face_offline':
        raise SystemExit('benchmark.readings reads the face_offline cell; '
                         '%s is %s (benchmark.control reads it)'
                         % (cell.name, cell.params['kind']))
    for seed in (int(s) for s in args.seeds.split(',')):
        readings = face_readings(cell, seed, device, args.sound_only)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'readings': readings}), flush=True)
        if device.type == 'cuda':
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
