"""Overhead of the sequence-sharded scan against a plain one.

The counterpart of eve_tpu's ``bench_temporal.py``:

    python -m eve_tpu_torch.bench.temporal [--device cuda|cpu]
        [--T 64] [--batch 8] [--features 128] [--iters 30] [--shards 2 4 8]

prints one JSON line, ``{"plain_scan_ms": ms, "sharded_scan_2_ms": ms,
"overhead_2x": r, ..., "metric": "sharded_scan_overhead_proxy", "T": 64,
"card": "..."}``.

The cell is eve_tpu's, ``h' = tanh(h @ W + x)`` from ``h = 0``, with
``W = randn(F, F) * 0.1`` and ``xs = randn(T, B, F)`` drawn from one
``RandomState(0)``, and 3 input variants ``xs + i`` cycled in the timed
loops. The tool times ``iters`` plain loops over the T steps, then, for
each ``n`` of ``--shards`` that divides T, ``iters`` calls of
``parallel.temporal.sharded_scan`` over a grid with only a ``seq`` axis
of ``n`` ranks, each followed by the sum of all outputs over the axis
(eve_tpu's ``jnp.sum(ys)``).

The tool starts the ranks itself: for each ``n``, ``n`` processes
(``torch.multiprocessing.spawn``) in a gloo group meeting on localhost.
On a card they all use the card named by ``--device``: NCCL refuses two
ranks on one card, and the chain's handoffs are two-rank broadcasts, which
gloo carries on CUDA tensors. With ``--device cpu`` they are gloo CPU
processes of one thread each, the counterpart of eve_tpu's virtual CPU
mesh. Every rank holds its block of the outputs to equal the plain
loop's over the whole sequence bit for bit before it times anything;
rank 0 reports its ms a call, and the tool prints the line. A rank that
fails fails the tool: the others are stopped and its traceback is raised.
"""

import argparse
import socket
import sys

import numpy as np
import torch

from eve_tpu_torch.bench import common

N_VARIANTS = 3


def scan_inputs(T, batch, features):
    """eve_tpu's ``(W, xs)`` as numpy float32: ``W`` (F, F) and ``xs``
    (T, B, F) from one ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    W = (rng.randn(features, features) * 0.1).astype(np.float32)
    xs = rng.randn(T, batch, features).astype(np.float32)
    return W, xs


def make_cell(W):
    """``cell(h, x) -> (h', h')`` with ``h' = tanh(h @ W + x)``."""
    def cell(carry, x):
        h = torch.tanh(carry @ W + x)
        return h, h
    return cell


def plain_scan(cell, carry, xs):
    """``lax.scan(cell, carry, xs)`` as a loop: ``(final carry, ys)``."""
    ys = []
    for x in xs:
        carry, y = cell(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


def device_inputs(args, device):
    """``(cell, carry0, [xs + i for i in range(3)])`` on ``device``."""
    W, xs = scan_inputs(args.T, args.batch, args.features)
    cell = make_cell(torch.from_numpy(W).to(device))
    carry0 = torch.zeros((args.batch, args.features), device=device)
    variants = [torch.from_numpy(xs + i).to(device)
                for i in range(N_VARIANTS)]
    return cell, carry0, variants


def run_rank(rank, args, world, address, results):
    """Rank ``rank`` of a ``seq`` grid of ``world``: check its block of
    the sharded outputs against the plain loop, then time ``args.iters``
    sharded scans; rank 0 puts its ms on ``results``."""
    from eve_tpu_torch.parallel import mesh as mesh_lib
    from eve_tpu_torch.parallel import temporal

    device = common.resolve_device(args.device)
    if device.type == 'cpu':
        torch.set_num_threads(1)
    mesh_lib.initialize_multihost(address, world, rank, local_rank=0,
                                  local_world=1, backend='gloo')
    try:
        grid = mesh_lib.make_mesh_nd({'seq': world})
        axis = grid.axis('seq')
        cell, carry0, variants = device_inputs(args, device)

        def sharded(xs):
            _, ys = temporal.sharded_scan(cell, carry0, xs, grid,
                                          axis_name='seq')
            return ys, temporal.seq_sum(ys.sum(), axis)

        with torch.no_grad():
            ys, _ = sharded(variants[0])
            start, stop = temporal.frame_range(args.T, axis)
            want = plain_scan(cell, carry0, variants[0])[1][start:stop]
            torch.testing.assert_close(ys, want, rtol=0, atol=0)
            ms = common.wall_ms(lambda xs: sharded(xs)[1],
                                [(xs,) for xs in variants], args.iters,
                                device)
        if rank == 0:
            results.put(ms)
    finally:
        mesh_lib.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def time_sharded(args, n):
    """ms a sharded scan over ``n`` ranks, as rank 0 measured it. A rank
    that fails stops the others and raises with its traceback."""
    results = torch.multiprocessing.get_context('spawn').SimpleQueue()
    torch.multiprocessing.spawn(
        run_rank, args=(args, n, 'localhost:%d' % _free_port(), results),
        nprocs=n, join=True)
    return results.get()


def measure(args):
    """The tool's JSON line without ``card``."""
    device = common.resolve_device(args.device)
    cell, carry0, variants = device_inputs(args, device)
    with torch.no_grad():
        t_plain = common.wall_ms(
            lambda xs: plain_scan(cell, carry0, xs)[1].sum(),
            [(xs,) for xs in variants], args.iters, device)
    results = {'plain_scan_ms': round(t_plain, 3)}
    for n in args.shards:
        if args.T % n:
            common.note('%d shards skipped: T = %d does not divide by it'
                        % (n, args.T))
            continue
        t = time_sharded(args, n)
        results['sharded_scan_%d_ms' % n] = round(t, 3)
        results['overhead_%dx' % n] = round(t / t_plain, 2)
    results['metric'] = 'sharded_scan_overhead_proxy'
    results['T'] = args.T
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--T', type=int, default=64)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--features', type=int, default=128)
    p.add_argument('--iters', type=int, default=30)
    p.add_argument('--shards', type=int, nargs='+', default=[2, 4, 8])
    p.add_argument('--device', default='cuda',
                   help='torch device of every rank (default cuda; raises '
                        'without a card)')
    args = p.parse_args(argv)
    common.emit(measure(args), torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
