"""Run one benchmark cell once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The run pins itself to a few cores, makes the cell's weights and inputs
from ``--seed``, warms up every shape the cell uses (the set-up, timed as
``setup_s`` from the process's start to the window's), measures for
``--seconds``, reads the peak memory, frees the program's state and holds
what the window produced against the plain reference (``correct``). With
``--trace 1`` a short stretch of the window runs under ``torch.profiler``
and the per-layer metrics replace the end-to-end ones.

Standard error carries the host probe, the card's clocks and, last, each
number compared beside its limit; standard output ends with one JSON line.
It exits without a result when no card (or too few) is visible, or when
JAX or the JAX package was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed, seconds, trace, device, start=START):
    """Drive ``cell`` once on ``device``: ``(result dict, checks)``, where
    checks are ``[(name, value, limit)]``."""
    import torch
    # As every entry point of the program: float32 means float32, without
    # TF32 in cuDNN or cuBLAS.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    driver = harness.load_module('traffic', cell.params['kind'])
    run = driver.run(cell, seed, seconds, bool(trace), device, start)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = harness.reader(m['name'])(run.record)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    run.release()
    checks, info = run.check()
    for name, value in info.items():
        harness.note('compared %s: %s' % (name, json.dumps(value)))
    correct = run.failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {'correct': bool(correct), 'attempted': run.attempted,
              'failed': run.failed, 'metrics': metrics,
              'device': device_entry(device, peak, run.record, trace)}
    if trace and run.record.get('stretch') is not None:
        stretch = run.record['stretch']
        result['breakdown'] = {'device_ops': stretch.top_device_ops(),
                               'idle_gaps': stretch.idle_gaps()}
    result['checks'] = {name: {'value': v, 'limit': lim}
                        for name, v, lim in checks}
    return result, checks


def device_entry(device, peak, record, trace):
    import torch
    if device.type == 'cuda':
        entry = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                 'count': 1, 'memory_peak_bytes': int(peak)}
    else:
        entry = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                 'memory_peak_bytes': 0}
    stretch = record.get('stretch')
    if trace and stretch is not None:
        entry['busy_s'] = stretch.busy_s
        entry['window_s'] = stretch.window_s
    return entry


def main(argv=None):
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    harness.require_devices(cell.chips)
    import torch
    cores = harness.pin_host()
    harness.note('host: cores %s, probe %.4f s' % (cores,
                                                   harness.host_probe()))
    harness.note('card before: %s' % harness.card_reading())
    device = torch.device('cuda', 0)
    result, checks = measure(cell, args.seed, args.seconds, args.trace,
                             device)
    harness.note('card after: %s' % harness.card_reading())
    harness.note('host: probe %.4f s' % harness.host_probe())
    loaded = harness.forbidden_modules()
    if loaded:
        harness.note('refusing to report: the run loaded %s' % loaded)
        sys.exit(3)
    for name, value, limit in checks:
        harness.note('check %s: %r (limit %r)' % (name, value, limit))
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
