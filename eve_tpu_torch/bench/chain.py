"""Device ms a batch of the flagship forward, with the host's share beside it.

The counterpart of eve_tpu's ``bench_chain.py``:

    python -m eve_tpu_torch.bench.chain [--device cuda|cpu]

prints one JSON line, ``{"metric": "eve_inference_device_ms_per_batch",
"value": ms, "unit": "ms", "frames_per_sec": ..., "batch": 16, "seq": 30,
"tpu_native_arch": false, "vs_baseline": 0, "chained_wall_ms": ms,
"latency_b1": {...}, "card": "..."}``.

eve_tpu takes the host out of its measurement by running K forwards inside
one jit, each perturbed by a scalar drawn from the previous one's output,
and reads ``(T[k2] - T[k1]) / (k2 - k1)`` off the host clock. Eager PyTorch
has no such loop: every forward is launched op by op from the host, and
bf16 serving on the card is bound by the host. So:

- ``value`` is the device-busy ms a forward, from ``torch.profiler`` (the
  union of the card's kernel, copy and set intervals; ``common.
  device_busy_ms``) over forwards k1..k2 of the chain: what the card
  itself spends. It is measured on a card only; ``--device cpu`` gives
  ``null``.
- ``chained_wall_ms`` is eve_tpu's formula over back-to-back forwards,
  each one's frames and head pose perturbed by a scalar drawn from the
  previous forward's output (eve_tpu's carry, which feeds every compute
  band), on the host clock with the card synchronised at the end.

The gap between the two is the host's share. ``latency_b1`` repeats both
at B = 1 with k1 = 4, k2 = 44 (eve_tpu's ``latency_b1_device_ms``).
"""

import argparse
import sys
import time

import torch

from eve_tpu_torch.bench import common

FRAME_KEYS = ('left_eye_patch', 'right_eye_patch', 'screen_frame')


def chained_forward(model, batch):
    """``step(s) -> s'``: one forward whose frames take ``s``'s parity (a
    0/1 added to the uint8 bytes) and whose head pose takes ``s``; ``s'``
    is the mean refined PoG, so each forward depends on the last."""
    def step(s):
        b = dict(batch)
        delta = (s.to(torch.int32) & 1).to(batch['left_eye_patch'].dtype)
        for k in FRAME_KEYS:
            if k in b:
                b[k] = batch[k] + delta
        b['left_h'] = batch['left_h'] + s
        out = model(b, output_predictions=True)
        return out['PoG_px_final'].float().mean()
    return step


def measure_device_ms(batch_size=16, seq=30, dtype='bfloat16',
                      tpu_native=False, stem='patchify', k1=2, k2=12,
                      device='cuda', eyes=common.EYES, wall=True):
    """``{'device_ms', 'chained_wall_ms'}`` a forward of the flagship model
    on one uint8 batch: device-busy ms over forwards k1..k2 (None off a
    card), and ``(T[k2] - T[k1]) / (k2 - k1)`` of the chain's wall. With
    ``wall`` False the chains are neither warmed nor timed on the host
    (``chained_wall_ms`` None): k1 forwards warm up, then the profiled
    ones run as before."""
    device = common.resolve_device(device)
    spec = common.flagship_spec(dtype, tpu_native, stem)
    model = common.init_flagship(spec, device).eval()
    (batch,) = common.make_batches(batch_size, seq, device, eyes, n=1)
    step = chained_forward(model, batch)
    with torch.inference_mode():
        zero = torch.zeros((), device=device)

        def chain(k, seed):
            s = zero
            for _ in range(k):
                s = step(s + seed * 1e-20)
            common.sync(device)
            return s

        # Warm-up: cuDNN's choices, the allocator.
        chained_wall_ms = None
        if wall:
            for k in (k1, k2):
                chain(k, 1.0)
            ts = {}
            for k in (k1, k2):
                t0 = time.perf_counter()
                chain(k, 2.0)
                ts[k] = time.perf_counter() - t0
            chained_wall_ms = (ts[k2] - ts[k1]) / (k2 - k1) * 1e3
        else:
            chain(k1, 1.0)
        device_ms = None
        if device.type == 'cuda':
            s = chain(k1, 3.0)
            carry = [s]

            def one():
                carry[0] = step(carry[0] + 3e-20)
            device_ms = common.device_busy_ms(one, device, k2 - k1)
    return {'device_ms': device_ms, 'chained_wall_ms': chained_wall_ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--seq', type=int, default=30)
    p.add_argument('--k1', type=int, default=2)
    p.add_argument('--k2', type=int, default=12)
    p.add_argument('--b1-k1', type=int, default=4,
                   help='k1 of the B = 1 latency chain')
    p.add_argument('--b1-k2', type=int, default=44,
                   help='k2 of the B = 1 latency chain')
    p.add_argument('--eyes', type=int, default=common.EYES,
                   help='eye patch size (eve_tpu fixes 128)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    p.add_argument('--dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--tpu-native-arch', action='store_true')
    p.add_argument('--tpu-native-stem', default='patchify',
                   choices=['patchify', 'patchify8'])
    args = p.parse_args(argv)

    kw = dict(seq=args.seq, dtype=args.dtype,
              tpu_native=args.tpu_native_arch, stem=args.tpu_native_stem,
              device=args.device, eyes=args.eyes)
    r = measure_device_ms(batch_size=args.batch, k1=args.k1, k2=args.k2,
                          **kw)
    b1 = measure_device_ms(batch_size=1, k1=args.b1_k1, k2=args.b1_k2, **kw)
    frames = args.batch * args.seq
    ms = r['device_ms']
    fps = None if ms is None else frames / ms * 1e3
    common.note('device time: %s ms/batch, chained wall %.2f ms/batch '
                '(%d frames)' % (ms, r['chained_wall_ms'], frames))
    common.emit({
        'metric': 'eve_inference_device_ms_per_batch',
        'value': None if ms is None else round(ms, 2),
        'unit': 'ms',
        'frames_per_sec': None if fps is None else round(fps, 1),
        'batch': args.batch, 'seq': args.seq,
        'tpu_native_arch': args.tpu_native_arch,
        'vs_baseline': 0,
        'chained_wall_ms': round(r['chained_wall_ms'], 2),
        'latency_b1': {
            'device_ms': (None if b1['device_ms'] is None
                          else round(b1['device_ms'], 3)),
            'chained_wall_ms': round(b1['chained_wall_ms'], 3),
            'k1': args.b1_k1, 'k2': args.b1_k2},
    }, torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
