"""Readings of the control (and of training's faults) that set the upper
end of each limit of ``correct``, and, for training, the sound program's
readings beside them.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        [--seconds <run_seconds>]

The control computes one step below the configuration's precision, on
the inputs and weights a run of that seed makes, at the cell's own size:
the sessions a run of ``--seconds`` samples, every distinct batch, or
the first three training steps.

- bfloat16 configurations: the plain reference put in the program's
  place with float8 e4m3 operands in its convolutions
  (``reference.precision``); the program has no float8 path.
- float32 configurations (TF32 off): the program's own TF32 path, cuDNN
  and cuBLAS with TF32 on, which rounds every convolution and matrix
  product of the forward and the backward; the same ``Program`` a run
  builds, beside it with TF32 off (the sound reading).

Each seed prints one JSON line with the numbers a run compares and, for
training, the worst leaf of each. For a training cell it also reads the
faults that the cell can have: half of each batch left out (the loss a
mean over the rest), and a step that returns its state unchanged (which
reads 1 on the parameters' change by construction and is printed as
such). The benchmark's own runs never run this.
"""

import argparse
import json

import torch

from benchmark import harness, weights as weights_lib
from benchmark.reference import eve as ref, precision
from benchmark.traffic import offline, stream, train


def control_rounding(cfg):
    """The reference's rounding that stands in for a bfloat16 program."""
    assert cfg.get('tpu_compute_dtype') == 'bfloat16', cfg.get(
        'tpu_compute_dtype')
    return precision.fp8


def stream_readings(cell, seed, seconds, device):
    p = cell.params
    cfg = cell.config['config']
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, device,
                                       cell.config['weights'])
    sessions = stream.Sessions(stream.make_pool(cell, seed, device), cell,
                               seed, p['sessions'])
    plan = stream.schedule(sessions, p['sessions'], stream.period_s(cell),
                           0.0, seconds)
    chunks = {}
    for _, i, k in plan:
        chunks[i] = max(chunks.get(i, 0), k + 1)
    pairs = {}
    for i in stream.sampled(seed, p['sessions'], p['check_sessions']):
        clip = sessions.clip_inputs(i, chunks[i])
        want = stream.reference_outputs(cfg, weights, clip, device)
        got = stream.reference_outputs(cfg, weights, clip, device,
                                       quant=control_rounding(cfg))
        stream.collect(pairs, got, want)
    return _judged(pairs, cell)


def _judged(pairs, cell):
    checks, info = stream.judged(pairs, cell.limits)
    return {'control': {name: value for name, value, _ in checks},
            'control_gaps': info}


def offline_readings(cell, seed, device):
    p = cell.params
    cfg = cell.config['config']
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, device,
                                       cell.config['weights'])
    pairs = {}
    for batch in offline.make_batches(cell, seed, device):
        want = offline.reference_batch(cfg, weights, batch, device,
                                       p['check_block_clips'])
        got = offline.reference_batch(cfg, weights, batch, device,
                                      p['check_block_clips'],
                                      quant=control_rounding(cfg))
        stream.collect(pairs, got, want)
    return _judged(pairs, cell)


def _as_program(reference):
    losses, first, _, change = reference
    return {'losses': losses, 'first_grads': first, 'change': change}


def _half(batch):
    """Half of the clips left out: the loss is the mean over the rest."""
    half = batch['left_eye_patch'].shape[0] // 2
    return {k: v[:half] for k, v in batch.items()}


def train_readings(cell, seed, device):
    cfg = cell.config['config']
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, device,
                                       cell.config['weights'])
    batches = train.make_batches(cell, seed)
    firsts = {}
    for name, tf32 in (('sound', False), ('control', True)):
        with harness.float32_mode(tf32=tf32):
            program = train.Program(cell, seed, weights, batches, device)
        firsts[name] = program.first
        program.release()
    with harness.float32_mode():
        reference = train.reference_steps(cfg, weights, batches, device)
        firsts['half_batch'] = _as_program(train.reference_steps(
            cfg, weights, [_half(b) for b in batches], device))
    moving = train.moving_leaves(reference[2])
    unchanged = _as_program(reference)
    unchanged['change'] = {k: torch.zeros_like(v)
                           for k, v in unchanged['change'].items()}
    firsts['state_unchanged'] = unchanged
    out = {'leaves_left_out': sorted(set(reference[2]) - set(moving))}
    for name, first in firsts.items():
        found = train.gaps(first, reference, moving)
        out[name] = {k: value for k, (value, _) in found.items()}
        out[name + '_worst_leaf'] = {k: leaf for k, (_, leaf) in
                                     found.items() if leaf is not None}
        out[name + '_loss_rel_each_step'] = train.loss_gaps(first,
                                                            reference)
        out[name + '_sign_flips'] = train.sign_flips(first, reference)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_devices(cell.chips)
    harness.pin_host()
    device = torch.device('cuda', 0)
    seconds = args.seconds or harness.run_seconds()
    for seed in (int(s) for s in args.seeds.split(',')):
        with harness.float32_mode():
            kind = cell.params['kind']
            if kind == 'stream':
                readings = stream_readings(cell, seed, seconds, device)
            elif kind == 'offline':
                readings = offline_readings(cell, seed, device)
            else:
                readings = train_readings(cell, seed, device)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'readings': readings}), flush=True)
        if device.type == 'cuda':
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
