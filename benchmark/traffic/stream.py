"""Open-loop sessions through the serving engine (``ServingEngine.submit``).

Each of ``sessions`` users streams a webcam video at the configuration's
``assumed_frame_rate`` as chunks of ``chunk_frames`` frames, one each time
the webcam has filled one (``period_s``), at a phase drawn from the seed;
chunks go out on their schedule whether or not earlier ones came back.
The eye size is the configuration's too. A session's video is a run of
consecutive chunks of one clip of a small seeded pool, from its own
offset, so the pool is shared and set-up makes no gigabytes of frames. The engine runs in its default host-stacked
mode with ``max_batch`` and ``max_delay_ms``; everything else at its
defaults.

A chunk's latency runs from its due time to its answer, so a stall in the
generator or the engine delays every chunk behind it. Chunks due in the
window count; a refused or failed chunk counts as failed.

``correct``: once the window has closed and the engine is gone, the
sessions ``check_sessions`` drawn from the seed are replayed through the
reference as one clip each (a session's chunks equal the whole video
streamed), and every served frame is compared.
"""

import heapq
import threading
import time

import numpy as np
import torch

from benchmark import compare, harness, synthetic, weights as weights_lib
from benchmark.reference import eve as ref


def period_s(cell):
    """Seconds between a session's chunks: a chunk's frames at the
    configuration's frame rate."""
    return (cell.params['chunk_frames']
            / cell.config['config']['assumed_frame_rate'])


def make_pool(cell, seed, device):
    p = cell.params
    _, _, eyes, fps = harness.shapes(cell.config['config'])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) + 1)
    return synthetic.make_synthetic_batch(
        synthetic.rng_for(seed, 1), p['pool_clips'], p['pool_frames'], eyes,
        with_gt=False, fps=fps, frame_generator=gen)


class Sessions:
    """Which pool clip, offset and phase each session has, and its
    chunks."""

    def __init__(self, pool, cell, seed, count):
        p = cell.params
        rng = synthetic.rng_for(seed, 2)
        self.pool = pool
        self.chunk = p['chunk_frames']
        self.fps = cell.config['config']['assumed_frame_rate']
        self.per_clip = p['pool_frames'] // self.chunk
        self.clip = rng.randint(0, p['pool_clips'], count)
        self.offset = rng.randint(0, self.per_clip, count)
        self.phase = rng.uniform(0.0, period_s(cell), count)

    def chunk_inputs(self, i, k):
        """Session ``i``'s ``k``-th chunk: a dict of (T, ...) arrays."""
        c = self.clip[i]
        a = ((self.offset[i] + k) % self.per_clip) * self.chunk
        out = {key: v[c, a:a + self.chunk] for key, v in self.pool.items()}
        ts = (k * self.chunk + np.arange(self.chunk)) * (1e9 / self.fps) + 1.0
        out['timestamps'] = ts.astype(np.float32)
        return out

    def clip_inputs(self, i, chunks):
        """Session ``i``'s first ``chunks`` chunks as one (1, T, ...)
        clip."""
        parts = [self.chunk_inputs(i, k) for k in range(chunks)]
        return {key: np.concatenate([p[key] for p in parts])[None]
                for key in parts[0]}


def make_engine(cell, weights, device):
    from eve_tpu_torch.models.eve import EveSpec
    from eve_tpu_torch.serve import ServingEngine
    spec = EveSpec.from_config(harness.port_config(cell.config['config']))
    p = cell.params
    return ServingEngine(spec, weights, device=device,
                         max_batch=p['max_batch'],
                         max_delay_ms=p['max_delay_ms'])


def warm_up(engine, sessions, params):
    """Full dispatches at the one shape every dispatch has (padded to
    ``max_batch``), on sessions of their own."""
    ids = [engine.open_session() for _ in range(params['max_batch'])]
    for k in range(params['warmup_chunks']):
        futures = [engine.submit(sessions.chunk_inputs(j, k), sid)
                   for j, sid in enumerate(ids)]
        for f in futures:
            f.result(timeout=600)
    for sid in ids:
        engine.close_session(sid)


def schedule(sessions, count, period, t0, seconds):
    """``(due, session, chunk)`` of every chunk due in the window."""
    out = []
    for i in range(count):
        k = 0
        while sessions.phase[i] + k * period < seconds:
            out.append((t0 + sessions.phase[i] + k * period, i, k))
            k += 1
    heapq.heapify(out)
    return [heapq.heappop(out) for _ in range(len(out))]


def drive(engine, sessions, ids, plan):
    """Submit every chunk of ``plan`` at its due time, from one thread
    (started here). Returns ``(thread, submitted, done, results, lock)``:
    per chunk its submit and answer times and its answer (None if it
    failed), filled in as they happen, under ``lock``."""
    done = [None] * len(plan)
    submitted = [None] * len(plan)
    results = [None] * len(plan)
    lock = threading.Lock()

    def finish(j):
        def callback(future):
            t = time.perf_counter()
            with lock:
                done[j] = t
                if future.exception() is None:
                    results[j] = future.result()
        return callback

    def generate():
        for j, (due, i, k) in enumerate(plan):
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            submitted[j] = time.perf_counter()
            try:
                future = engine.submit(sessions.chunk_inputs(i, k), ids[i])
            except Exception:  # noqa: BLE001 - a refusal is a failed chunk
                with lock:
                    done[j] = submitted[j]
                continue
            future.add_done_callback(finish(j))

    thread = threading.Thread(target=generate, name='benchmark-loadgen')
    thread.start()
    return thread, submitted, done, results, lock


def run(cell, seed, seconds, trace, device, start):
    p = cell.params
    cfg = cell.config['config']
    specs = ref.param_specs(cfg)
    weights = weights_lib.make_weights(specs, seed, device,
                                       cell.config['weights'])
    pool = make_pool(cell, seed, device)
    count = p['sessions']
    sessions = Sessions(pool, cell, seed, count)
    engine = make_engine(cell, weights, device)
    warm_up(engine, sessions, p)
    ids = [engine.open_session() for _ in range(count)]
    tracer = None
    if trace:
        from benchmark.trace import Tracer
        tracer = Tracer(device)
    stats0 = engine.get_stats()
    t0 = time.perf_counter() + p['lead_s']
    setup_s = t0 - start
    plan = schedule(sessions, count, period_s(cell), t0, seconds)
    thread, submitted, done, results, lock = drive(engine, sessions, ids,
                                                   plan)
    stretch_units = None
    if trace:
        # The stretch is the window's last seconds. Stopping the profiler
        # holds the interpreter for seconds, which would stall the load
        # generator, so it stops once every chunk has gone out.
        time.sleep(max(0.0, t0 + seconds - p['trace_stretch_s']
                       - time.perf_counter()))
        before = engine.get_stats()
        tracer.start()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        tracer.end()
        stretch_units = engine.get_stats()['batches'] - before['batches']
    thread.join()
    if trace:
        tracer.stop()
    deadline = t0 + seconds + p['drain_s']
    while time.perf_counter() < deadline:
        with lock:
            if all(d is not None for d in done):
                break
        time.sleep(0.01)
    stats1 = engine.get_stats()
    with lock:
        done = list(done)
    lat, failed = [], 0
    for j, (due, _, _) in enumerate(plan):
        if done[j] is None or results[j] is None:
            # A failed chunk waited until the run gave up on it.
            failed += 1
            lat.append((deadline - due) * 1e3)
        else:
            lat.append((done[j] - due) * 1e3)
    record = {
        'setup_s': setup_s, 'window_s': seconds,
        'latencies_ms': lat, 'period_ms': period_s(cell) * 1e3,
        'attempted': len(plan), 'failed': failed,
        'lags_ms': [(s - due) * 1e3 for s, (due, _, _) in
                    zip(submitted, plan) if s is not None],
        'units': stats1['batches'] - stats0['batches'],
        'batched_slots': stats1['batched_slots'] - stats0['batched_slots'],
        'max_batch': p['max_batch'],
        'stretch': tracer.read() if tracer else None,
        'on_card': device.type == 'cuda',
        'stretch_units': stretch_units,
    }
    harness.note('stream: %d chunks, %d failed, %d dispatches, engine %s'
                 % (len(plan), failed, record['units'], stats1))
    harness.note('stream latency ms: mean %.4f, p50 %.4f, p95 %.4f, '
                 'p99 %.4f, max %.4f; lag p95 %.4f'
                 % ((float(np.mean(lat)),)
                    + tuple(np.percentile(lat, (50, 95, 99, 100)))
                    + (np.percentile(record['lags_ms'], 95),)))

    def release():
        engine.stop()
        if device.type == 'cuda':
            torch.cuda.empty_cache()

    def check():
        return check_sessions(cell, seed, sessions, plan, results, weights,
                              device)

    return harness.Run(record=record, attempted=len(plan), failed=failed,
                       release=release, check=check)


def sampled(seed, count, n):
    rng = synthetic.rng_for(seed, 3)
    return sorted(rng.choice(count, size=min(n, count), replace=False))


def reference_outputs(cfg, weights, clip, device, quant=None):
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in clip.items()}
    with torch.no_grad():
        out = ref.forward(weights, cfg, batch,
                          quant=quant or (lambda t: t))
    return {k: out[k][0].cpu().numpy() for k in COMPARED}


# The number a check reads when a sampled chunk never got its answer.
MISSING = 1e30
COMPARED = ('PoG_px_initial', 'PoG_px_final')


def collect(pairs, got, want):
    """Add each compared frame's program and reference outputs to
    ``pairs`` ({output: ([program arrays], [reference arrays])})."""
    for key in COMPARED:
        mine, theirs = pairs.setdefault(key, ([], []))
        mine.append(np.asarray(got[key]).reshape(-1, 2))
        theirs.append(np.asarray(want[key]).reshape(-1, 2))


def judged(pairs, limits):
    """``(checks, info)``: the initial point of gaze's mean gap a frame in
    px, and the refined one's normalised squared error, each against its
    limit; the gaps' quantiles beside them."""
    both = {k: (np.concatenate(a), np.concatenate(b))
            for k, (a, b) in pairs.items()}
    info = {k: compare.summary(compare.frame_gaps(*v))
            for k, v in both.items()}
    values = {'pog_initial_px_mean': info['PoG_px_initial']['mean'],
              'pog_final_nmse': compare.nmse(*both['PoG_px_final'])}
    return [(name, values[name], limits[name]) for name in CHECKS], info


CHECKS = ('pog_initial_px_mean', 'pog_final_nmse')


def check_sessions(cell, seed, sessions, plan, results, weights, device):
    """Every served frame of the sampled sessions against the reference
    over each session's whole video. A sampled chunk with no answer fails
    the run."""
    with harness.float32_mode():
        cfg = cell.config['config']
        chunks = {}
        for j, (_, i, k) in enumerate(plan):
            chunks.setdefault(i, {})[k] = results[j]
        pairs = {}
        for i in sampled(seed, cell.params['sessions'],
                         cell.params['check_sessions']):
            served = chunks.get(i, {})
            n = len(served)
            if n == 0 or any(served.get(k) is None for k in range(n)):
                harness.note('session %d: a sampled chunk has no answer' % i)
                return [(name, MISSING, cell.limits[name])
                        for name in CHECKS], {}
            got = {key: np.concatenate([served[k][key] for k in range(n)])
                   for key in COMPARED}
            collect(pairs, got, reference_outputs(
                cfg, weights, sessions.clip_inputs(i, n), device))
        return judged(pairs, cell.limits)
