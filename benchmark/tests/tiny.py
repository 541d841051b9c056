"""Small sizes at which the CPU rehearses every cell, and a helper that
drives one run of a cell there (past the look for a card).

The cells' limits are set for their own sizes on the card; at the small
sizes the rehearsal computes in float32, where the program equals the
reference to rounding, so that a sound run is correct and a broken one
is not. One limit is the tiny size's own: with 6 frames a batch more of
each leaf's gradient is zero to rounding, so the median leaf's change
reads 5e-5 to 8e-5 in sound float32 runs (against at most 1e-5 at the
cell's size) and 2e-3 to 9e-3 with half of each batch left out (float32
runs on a CPU, 3 seeds); ``TINY_LIMITS`` sits between."""

import time

import torch

from benchmark import harness, run

SEED = 2 ** 31 + 12345
# The configuration cut to a tiny size (the traffic mixes hold no sizes);
# at 2 frames a second a stream's chunk of 2 frames comes each second.
TINY_CONFIG = dict(eyes_size=[64, 64], batch_size=2, test_batch_size=2,
                   max_sequence_len=3, assumed_frame_rate=2)
TINY = {
    'stream': dict(chunk_frames=2, max_batch=2, sessions=3, pool_clips=2,
                   pool_frames=8, warmup_chunks=1, check_sessions=2,
                   trace_stretch_s=1.0, lead_s=0.2, drain_s=30.0),
    'offline': dict(trace_batches=[1, 2], check_block_clips=1),
    'train': dict(trace_steps=[1, 2], warmup_steps=4),
}
TINY_LIMITS = {'train': {'change_gap_median_leaf': 5e-4}}
CELLS = ('eve-refine-bf16.stream', 'eve-refine-bf16.offline',
         'eyenet-f32.train')


def tiny_cell(name, float32=True):
    cell = harness.load_cell(name)
    cell.params.update(TINY[cell.params['kind']])
    cell.config['config'].update(TINY_CONFIG)
    cell.limits.update(TINY_LIMITS.get(cell.params['kind'], {}))
    if float32:
        cell.config['config']['tpu_compute_dtype'] = 'float32'
    return cell


def measure(name, seconds=2.0, trace=0, seed=SEED):
    """One run of cell ``name`` at its tiny size on the CPU: the result
    dict a run prints."""
    torch.set_num_threads(2)
    result, _ = run.measure(tiny_cell(name), seed, seconds, trace,
                            torch.device('cpu'), start=time.perf_counter())
    return result
