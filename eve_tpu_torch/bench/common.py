"""What every measuring tool shares: the flagship workload, the device and
its clock, the card line and the JSON line.

The flagship workload is eve_tpu's (``bench.py``): the reference topology
with RefineNet and screen content (``EveSpec(refine_net_enabled=True,
load_screen_content=True, compute_dtype=..., tpu_native_arch=...,
tpu_native_stem=...)``, every other field at its default), weights from
``init_model`` on a seeded generator, and ``N_VARIANTS`` distinct batches
from ``make_synthetic_batch`` on ``np.random.RandomState(0)`` at 128x128
eyes, moved to the device before any timing starts and cycled in the
timed loops.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as eve_lib
from eve_tpu_torch.utils.tensors import batch_to_tensors

N_VARIANTS = 4
EYES = 128
# What eve_tpu's bench ``infer`` returns from a forward.
INFER_OUTPUTS = ('PoG_px_initial', 'PoG_px_final', 'left_pupil_size',
                 'right_pupil_size')


def resolve_device(device):
    """``device`` as a ``torch.device`` (a card with its index), with
    TF32 off; a CUDA device without a visible card raises (no tool falls
    back to the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'device %s asked for, but no CUDA card is visible '
                '(torch.cuda.is_available() is False); pass --device cpu to '
                'run the plain versions on the CPU' % device)
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    # cuDNN runs float32 convolutions in TF32 by default; the port's float32
    # is eve_tpu's float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def sync(device):
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def card_line(device):
    """The cards' names and power limits, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (one
    card: its one line), or ``'cpu'``."""
    if device.type != 'cuda':
        return 'cpu'
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return '; '.join(line.strip() for line in out.splitlines()
                     if line.strip())


def emit(line, device):
    """Print ``line`` with the ``card`` field as the tool's JSON line."""
    line = dict(line, card=card_line(resolve_device(device)))
    print(json.dumps(line), flush=True)
    return line


def note(*args):
    """A line for the reader on stderr (stdout holds the JSON line)."""
    print(*args, file=sys.stderr, flush=True)


def flagship_spec(dtype='bfloat16', tpu_native=False, stem='patchify',
                  refine=True, remat='none'):
    """eve_tpu's bench ``EveSpec``; ``refine=False`` is its eye-only
    model (no RefineNet, no screen)."""
    return eve_lib.EveSpec(
        refine_net_enabled=refine, load_screen_content=refine,
        compute_dtype=dtype, tpu_native_arch=tpu_native,
        tpu_native_stem=stem, remat=remat)


def init_flagship(spec, device):
    """``init_model`` of ``spec`` on ``device`` from a generator seeded
    with 0 (the same weights on any device)."""
    return eve_lib.init_model(spec, torch.Generator().manual_seed(0), device)


def make_batches(batch_size, seq, device, eyes=EYES, input_dtype='uint8',
                 with_screen=True, n=N_VARIANTS):
    """``n`` distinct labelled batches from one ``RandomState(0)``, as
    device tensors. ``input_dtype`` 'uint8' gives raw camera and screen
    bytes (scaled on the device), 'float32' frames in [0, 1]."""
    rng = np.random.RandomState(0)
    frame_dtype = np.uint8 if input_dtype == 'uint8' else np.float32
    batches = []
    for _ in range(n):
        b = make_synthetic_batch(rng, batch_size=batch_size,
                                 sequence_len=seq, eyes_size=eyes,
                                 with_screen=with_screen,
                                 frame_dtype=frame_dtype)
        batches.append(batch_to_tensors(b, device))
    sync(device)
    return batches


def infer(model, batch):
    """eve_tpu's bench ``infer``: ``forward(training=False,
    output_predictions=True)`` reduced to ``INFER_OUTPUTS``. Call it under
    ``torch.inference_mode()``."""
    out = model(batch, output_predictions=True)
    return tuple(out[k] for k in INFER_OUTPUTS)


def wall_ms(fn, args_list, iters, device):
    """Host ms a call of ``fn(*args)`` over ``iters`` calls that cycle
    ``args_list``, after one warm-up call, synchronised at both ends (eve_tpu's
    ``_time``)."""
    fn(*args_list[0])
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def union_ms(intervals):
    """Total length of the union of ``(start, end)`` intervals, in the
    intervals' unit divided by 1e3 (µs in, ms out)."""
    total, end = 0.0, -float('inf')
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def raw_events(prof):
    """The events of a finished ``torch.profiler.profile``, as its tracer
    recorded them (``prof.profiler.kineto_results``, which torch does not
    document: a release without it raises here, never a quieter time)."""
    results = getattr(getattr(prof, 'profiler', None), 'kineto_results',
                      None)
    if results is None:
        raise RuntimeError('this torch (%s) has no profiler.kineto_results: '
                           'device_busy_ms cannot read the raw events'
                           % torch.__version__)
    return results.events()


def device_busy_ms(fn, device, steps):
    """Device-busy ms a call of ``fn`` over ``steps`` calls: the union of
    the intervals of every kernel, copy and set that ``torch.profiler``
    records on the card (so overlapping streams count once). The card only:
    a CPU has no device clock here.

    Only the card's activity is recorded, and its intervals are read from
    the profiler's raw events: recording the host's ops and building
    ``prof.events()`` give the same busy time, but take most of a
    measurement's seconds at B = 1 (some 3,000 device events a forward)."""
    if device.type != 'cuda':
        raise ValueError('device-busy time is measured on a card, not on %s'
                         % device)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        sync(device)
    intervals = [(e.start_ns() / 1e3, e.end_ns() / 1e3)
                 for e in raw_events(prof)
                 if e.device_type() == DeviceType.CUDA]
    if not intervals:
        raise RuntimeError('torch.profiler recorded no device activity')
    return union_ms(intervals) / steps
