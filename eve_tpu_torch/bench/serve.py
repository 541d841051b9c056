"""Sustained closed-loop serving through ``ServingEngine``.

The counterpart of eve_tpu's ``bench_serve.py``:

    python -m eve_tpu_torch.bench.serve [--device cuda|cpu] [--loopback]

N concurrent sessions each keep exactly one chunk of T frames in flight
(closed-loop clients) through the micro-batching engine; inputs are uint8
camera and screen bytes, the wire format. Each session cycles ``--distinct``
chunk payloads. Prints one JSON line: sustained frames/s over all sessions
(``serve_sustained_frames_per_sec``, or ``serve_loopback_frames_per_sec``
under ``--loopback``), per-chunk latency p50/p95 (the warm-up request
excluded), the engine's ``batches`` and ``requests`` (the warm-up
included), and ``card``.

``--loopback`` serves with ``device_resident=True`` and every payload
pre-staged as a device tensor (``submit`` passes a tensor through
untouched), so no input crosses to the card in the chunk path, and adds:

- ``raw_step_ms``: back-to-back forwards of one ``max_batch`` batch with
  the states threaded, outputs left on the device;
- ``roundtrip_step_ms``: the same, each followed by a host read of the
  served outputs, as a request/response cycle is serialised;
- ``engine_batch_ms``: the timed window's wall a dispatched micro-batch,
  and ``batcher_overhead_ms``, that less ``roundtrip_step_ms``;
- ``host_batcher_ms``: the engine's own cost a micro-batch with its
  forward stubbed by a host function that returns zeros for the served
  outputs and hands the states back (``_null_engine_batch_ms``):
  queueing, gather windows, grouping, state threading and futures,
  everything but the model.

``--num-devices n`` serves over a mesh of n (``ServingEngine(mesh=n)``);
with fewer cards than n, n replicas share the one named by ``--device``.
"""

import argparse
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from eve_tpu_torch.bench import common
from eve_tpu_torch.utils.tensors import batch_to_tensors


def session_clips(args):
    """``{session: [chunk, ...]}``: ``args.distinct`` uint8 chunks of
    ``args.seq`` frames a session, from one ``RandomState(0)``."""
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    rng = np.random.RandomState(0)
    clips = {}
    for s in range(args.sessions):
        batch = make_synthetic_batch(
            rng, batch_size=args.distinct, sequence_len=args.seq,
            eyes_size=args.eyes, with_screen=True, frame_dtype=np.uint8)
        clips[s] = [{k: v[i] for k, v in batch.items()}
                    for i in range(args.distinct)]
    return clips


def _raw_step_ms(model, spec, clips, args, device, iters=12):
    """The two floors of the engine's batch time: ``(device-resident ms,
    round-trip ms)`` a forward of a ``max_batch`` batch (see the module
    docstring)."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.serve import DEFAULT_SERVED_OUTPUTS

    def step(batch, states):
        out = model(batch, output_predictions=True, initial_states=states,
                    return_states=True)
        served = {k: out[k] for k in DEFAULT_SERVED_OUTPUTS if k in out}
        return served, out['states']

    batches = []
    for v in range(args.distinct):
        chunks = [clips[s % args.sessions][v] for s in range(args.max_batch)]
        batches.append({k: torch.stack([c[k] for c in chunks])
                        for k in chunks[0]})
    with torch.inference_mode():
        _, states = step(batches[0], eve_lib.init_stream_state(
            spec, args.max_batch, device))
        common.sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            _, states = step(batches[i % len(batches)], states)
        common.sync(device)
        device_ms = (time.perf_counter() - t0) / iters * 1e3
        t0 = time.perf_counter()
        for i in range(iters):
            out, states = step(batches[i % len(batches)], states)
            _ = {k: v.cpu().numpy() for k, v in out.items()}
        roundtrip_ms = (time.perf_counter() - t0) / iters * 1e3
    return device_ms, roundtrip_ms


def _null_engine_batch_ms(spec, params, host_clips, args, device):
    """The engine's own ms a dispatched micro-batch, its forward stubbed
    by a host function (see the module docstring)."""
    from eve_tpu_torch.serve import ServingEngine

    engine = ServingEngine(spec, params, device=device,
                           max_batch=args.max_batch, max_delay_ms=5.0,
                           request_timeout_s=600.0)
    T = args.seq

    def null_forward(model, batch, states):
        n = next(iter(batch.values())).shape[0]
        return ({'PoG_px_initial': torch.zeros((n, T, 2)),
                 'PoG_px_final': torch.zeros((n, T, 2)),
                 'left_pupil_size': torch.zeros((n, T)),
                 'right_pupil_size': torch.zeros((n, T))}, states)

    engine._forward = null_forward
    try:
        errors = []

        def client(s):
            try:
                sid = engine.open_session()
                for i in range(args.chunks):
                    engine.infer(host_clips[s][i % args.distinct],
                                 session_id=sid, timeout=120)
                engine.close_session(sid)
            except Exception as exc:  # noqa: BLE001 - raised below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(s,), daemon=True)
                   for s in range(args.sessions)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return wall / max(engine.stats['batches'], 1) * 1e3
    finally:
        engine.stop()


def measure_host_batcher_ms(sessions=4, chunks=8, seq=30, max_batch=4,
                            eyes=common.EYES, dtype='bfloat16',
                            device='cuda'):
    """``host_batcher_ms`` alone: the engine's own cost a dispatched
    micro-batch at zero model time."""
    device = common.resolve_device(device)
    args = SimpleNamespace(sessions=sessions, chunks=chunks, seq=seq,
                           max_batch=max_batch, eyes=eyes, distinct=4)
    spec = common.flagship_spec(dtype)
    params = common.init_flagship(spec, device).state_dict()
    return _null_engine_batch_ms(spec, params, session_clips(args), args,
                                 device)


def serving_mesh(num_devices, device):
    """``mesh=`` of the engine: None for one device, n when there are n
    cards, else n replicas of ``device``."""
    from eve_tpu_torch.parallel import mesh as mesh_lib
    if num_devices <= 1:
        return None
    if device.type == 'cuda' and torch.cuda.device_count() >= num_devices:
        return num_devices
    common.note('%d replicas share %s' % (num_devices, device))
    return mesh_lib.make_mesh(devices=[device] * num_devices)


def measure_serving(sessions=4, chunks=8, seq=30, max_batch=4,
                    eyes=common.EYES, distinct=4, dtype='bfloat16',
                    tpu_native=False, num_devices=0, loopback=False,
                    device='cuda'):
    """The tool's JSON line without ``card``: sustained frames/s,
    per-chunk latency percentiles and the engine's counts (the loopback
    keys under ``loopback``)."""
    from eve_tpu_torch.serve import ServingEngine

    device = common.resolve_device(device)
    args = SimpleNamespace(sessions=sessions, chunks=chunks, seq=seq,
                           max_batch=max_batch, eyes=eyes, distinct=distinct)
    spec = common.flagship_spec(dtype, tpu_native)
    model = common.init_flagship(spec, device).eval()
    params = model.state_dict()
    clips = session_clips(args)
    raw_step_ms = roundtrip_ms = null_batch_ms = None
    if loopback:
        null_batch_ms = _null_engine_batch_ms(spec, params, clips, args,
                                              device)
        # Every payload on the device: no input crosses in the timed window.
        clips = {s: [batch_to_tensors(chunk, device) for chunk in chunks_]
                 for s, chunks_ in clips.items()}
        raw_step_ms, roundtrip_ms = _raw_step_ms(model, spec, clips, args,
                                                 device)
    engine = ServingEngine(spec, params, device=device, max_batch=max_batch,
                           max_delay_ms=5.0, request_timeout_s=600.0,
                           device_resident=loopback,
                           mesh=serving_mesh(num_devices, device))
    latencies = []
    lat_lock = threading.Lock()
    errors = []
    try:
        engine.submit(clips[0][0]).result(timeout=600)  # warm-up

        def client(s):
            try:
                sid = engine.open_session()
                for i in range(chunks):
                    t0 = time.perf_counter()
                    engine.submit(clips[s][i % distinct],
                                  session_id=sid).result(timeout=600)
                    dt = time.perf_counter() - t0
                    with lat_lock:
                        latencies.append(dt)
                engine.close_session(sid)
            except Exception as exc:  # noqa: BLE001 - raised below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(s,), daemon=True)
                   for s in range(sessions)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    if errors:
        raise errors[0]

    frames = sessions * chunks * seq
    lat_ms = np.array(latencies) * 1e3
    result = {
        'metric': ('serve_loopback_frames_per_sec' if loopback
                   else 'serve_sustained_frames_per_sec'),
        'value': round(frames / wall, 2),
        'unit': 'frames/s',
        'sessions': sessions,
        'chunk_frames': seq,
        'max_batch': max_batch,
        'chunk_p50_ms': round(float(np.percentile(lat_ms, 50)), 1),
        'chunk_p95_ms': round(float(np.percentile(lat_ms, 95)), 1),
        'batches': engine.stats['batches'],
        'requests': engine.stats['requests'],
        'tpu_native_arch': tpu_native,
        'num_devices': num_devices,
    }
    if loopback:
        engine_batch_ms = wall / max(engine.stats['batches'], 1) * 1e3
        result['raw_step_ms'] = round(raw_step_ms, 2)
        result['roundtrip_step_ms'] = round(roundtrip_ms, 2)
        result['engine_batch_ms'] = round(engine_batch_ms, 2)
        result['batcher_overhead_ms'] = round(
            engine_batch_ms - roundtrip_ms, 2)
        result['host_batcher_ms'] = round(null_batch_ms, 2)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--sessions', type=int, default=4)
    p.add_argument('--chunks', type=int, default=8,
                   help='timed chunks per session')
    p.add_argument('--seq', type=int, default=30, help='frames per chunk')
    p.add_argument('--max-batch', type=int, default=4)
    p.add_argument('--eyes', type=int, default=common.EYES)
    p.add_argument('--distinct', type=int, default=4,
                   help='distinct chunk payloads cycled per session')
    p.add_argument('--dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--tpu-native-arch', action='store_true',
                   help='serve the opt-in topology instead of the reference '
                        'one')
    p.add_argument('--num-devices', type=int, default=0,
                   help='serve data-parallel over n devices (replicas of '
                        '--device when fewer cards are visible)')
    p.add_argument('--loopback', action='store_true',
                   help='device-resident engine with the payloads already on '
                        'the device; adds the raw-step floors and the '
                        'batcher\'s own cost')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    args = p.parse_args(argv)
    result = measure_serving(
        sessions=args.sessions, chunks=args.chunks, seq=args.seq,
        max_batch=args.max_batch, eyes=args.eyes, distinct=args.distinct,
        dtype=args.dtype, tpu_native=args.tpu_native_arch,
        num_devices=args.num_devices, loopback=args.loopback,
        device=args.device)
    common.emit(result, torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
