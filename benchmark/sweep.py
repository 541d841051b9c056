"""Find the stream cell's knee: the most sessions the engine serves
without a growing backlog.

    python3 -m benchmark.sweep --workload eve-refine-bf16.stream \\
        --sessions 80,120,160,200 --seconds 10 --seed 7

One engine (the cell's configuration and settings) is built and warmed up
once; each session count then runs the cell's open loop for ``--seconds``
on fresh sessions and drains. Each count prints one JSON line: chunks due,
failed, completed a second, the latency's median, 95th percentile and
maximum, and the mean latency of the last third of the window over the
first third's (a backlog that grows reads well above 1). The benchmark's
own runs never run this; the cell's file keeps what a sweep found.
"""

import argparse
import json
import time

import numpy as np
import torch

from benchmark import harness, weights as weights_lib
from benchmark.reference import eve as ref
from benchmark.traffic import stream


def sweep_one(engine, sessions, count, period, seconds, drain_s):
    ids = [engine.open_session() for _ in range(count)]
    t0 = time.perf_counter() + 0.5
    plan = stream.schedule(sessions, count, period, t0, seconds)
    thread, _, done, results, lock = stream.drive(engine, sessions, ids,
                                                  plan)
    thread.join()
    deadline = t0 + seconds + drain_s
    while time.perf_counter() < deadline:
        with lock:
            if all(d is not None for d in done):
                break
        time.sleep(0.01)
    with lock:
        done = list(done)
    for sid in ids:
        engine.close_session(sid)
    ok = [(due, d) for (due, _, _), d, r in zip(plan, done, results)
          if d is not None and r is not None]
    lat = np.array([(d - due) * 1e3 for due, d in ok])
    dues = np.array([due - t0 for due, _ in ok])
    early = lat[dues < seconds / 3]
    late = lat[dues >= 2 * seconds / 3]
    in_window = sum(1 for due, d in ok if d - t0 <= seconds)
    return {
        'sessions': count, 'due': len(plan), 'failed': len(plan) - len(ok),
        'completed_per_s': in_window / seconds,
        'p50_ms': float(np.percentile(lat, 50)) if len(lat) else None,
        'p95_ms': float(np.percentile(lat, 95)) if len(lat) else None,
        'max_ms': float(lat.max()) if len(lat) else None,
        'growth': (float(late.mean() / early.mean())
                   if len(early) and len(late) else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', default='eve-refine-bf16.stream')
    ap.add_argument('--sessions', required=True)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_devices(cell.chips)
    cores = harness.pin_host()
    harness.note('host: cores %s, probe %.4f s; card: %s'
                 % (cores, harness.host_probe(), harness.card_reading()))
    device = torch.device('cuda', 0)
    p = cell.params
    counts = [int(s) for s in args.sessions.split(',')]
    cfg = cell.config['config']
    weights = weights_lib.make_weights(ref.param_specs(cfg), args.seed,
                                       device, cell.config['weights'])
    sessions = stream.Sessions(stream.make_pool(cell, args.seed, device),
                               cell, args.seed, max(counts))
    engine = stream.make_engine(cell, weights, device)
    stream.warm_up(engine, sessions, p)
    for count in counts:
        line = sweep_one(engine, sessions, count, stream.period_s(cell),
                         args.seconds, p['drain_s'])
        line['probe_s'] = harness.host_probe()
        print(json.dumps(line), flush=True)
    engine.stop()


if __name__ == '__main__':
    main()
