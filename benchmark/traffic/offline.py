"""Recorded video evaluated offline through ``infer.iterator``: the
Codalab evaluation and reprocessing path.

Unlabelled clips of the configuration's ``test_batch_size`` x
``max_sequence_len`` frames (its eye size, its frame rate), uint8 on the
host as the reader hands them (the timestamps int64 nanoseconds), go
through ``infer.iterator(model, batches, create_images=False,
materialize_inputs=False)``, the evaluation CLI's call; ``distinct_batches``
seeded batches are cycled. The window runs whole batches until
``--seconds`` have passed; the rate is every frame of those batches over
the time they took.

``correct``: once the window has closed and the model is gone, the
reference evaluates each distinct batch once, in blocks of clips, and
every batch the window produced is compared with it.
"""

import time

import numpy as np
import torch

from benchmark import harness, synthetic, weights as weights_lib
from benchmark.reference import eve as ref
from benchmark.traffic.stream import COMPARED, collect, judged


def make_batches(cell, seed, device):
    B, T, eyes, fps = harness.shapes(cell.config['config'], 'test_batch_size')
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) + 1)
    rng = synthetic.rng_for(seed, 1)
    out = []
    for _ in range(cell.params['distinct_batches']):
        b = synthetic.make_synthetic_batch(
            rng, B, T, eyes, with_gt=False, fps=fps, frame_generator=gen)
        # The reader's stamps: int64 nanoseconds, rebased by the iterator.
        b['timestamps'] = (b['timestamps'].astype(np.int64)
                           + 1_600_000_000_000_000_000)
        out.append(b)
    return out


def run(cell, seed, seconds, trace, device, start):
    from eve_tpu_torch import infer
    from eve_tpu_torch.models import eve as eve_lib
    p = cell.params
    cfg = cell.config['config']
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, device,
                                       cell.config['weights'])
    spec = eve_lib.EveSpec.from_config(harness.port_config(cfg))
    model = eve_lib.build_model(spec, weights, device)
    batches = make_batches(cell, seed, device)
    B, T, eyes, _ = harness.shapes(cfg, 'test_batch_size')
    frames = B * T

    def evaluate(feed):
        return infer.iterator(model, feed, create_images=False,
                              materialize_inputs=False)

    for _ in evaluate(batches):   # warm-up: every distinct batch once
        pass
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

    def cycle():
        i = 0
        while True:
            yield batches[i % len(batches)]
            i += 1

    tracer = None
    if trace:
        from benchmark.trace import Tracer
        tracer = Tracer(device)
    first, last = p['trace_batches']
    kept = []
    t0 = time.perf_counter()
    setup_s = t0 - start
    for step, _, out in evaluate(cycle()):
        kept.append({k: out[k] for k in COMPARED})
        if tracer is not None and step + 1 == first:
            tracer.start()
        if tracer is not None and step + 1 == last:
            tracer.stop()
        if time.perf_counter() - t0 >= seconds and (
                tracer is None or tracer.stopped):
            break
    window_s = time.perf_counter() - t0
    record = {
        'setup_s': setup_s, 'window_s': window_s,
        'on_card': device.type == 'cuda',
        'units': len(kept), 'frames': len(kept) * frames,
        'stretch': tracer.read() if tracer else None,
        'stretch_units': last - first,
        'kernel_calls': {
            'render_heatmaps_kernel': {'n': frames, 'sigmas': 1,
                                       'masked': False},
            'soft_argmax_kernel': {'n': frames}},
        'flops_per_unit': None, 'peak_flops_dtype':
            cfg.get('tpu_compute_dtype', 'float32'),
    }
    if trace:
        from benchmark.reference import flops
        record['flops_per_unit'] = flops.forward(cfg, B, T, eyes)
    harness.note('offline: %d batches of %d frames in %.3f s'
                 % (len(kept), frames, window_s))
    holder = {'model': model}

    def release():
        holder.clear()
        if device.type == 'cuda':
            torch.cuda.empty_cache()

    def check():
        return check_batches(cell, weights, batches, kept, device)

    return harness.Run(record=record, attempted=len(kept), failed=0,
                       release=release, check=check)


def reference_batch(cfg, weights, batch, device, block, quant=None):
    """The reference's outputs for one host batch, ``block`` clips at a
    time."""
    outs = {k: [] for k in COMPARED}
    B = batch['left_eye_patch'].shape[0]
    for a in range(0, B, block):
        part = {k: torch.from_numpy(np.ascontiguousarray(v[a:a + block]))
                .to(device) for k, v in batch.items()
                if k != 'timestamps'}
        with torch.no_grad():
            out = ref.forward(weights, cfg, part,
                              quant=quant or (lambda t: t))
        for k in COMPARED:
            outs[k].append(out[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in outs.items()}


def check_batches(cell, weights, batches, kept, device):
    with harness.float32_mode():
        cfg = cell.config['config']
        want = [reference_batch(cfg, weights, b, device,
                                cell.params['check_block_clips'])
                for b in batches]
        pairs = {}
        for i, got in enumerate(kept):
            collect(pairs, got, want[i % len(batches)])
        return judged(pairs, cell.limits)
