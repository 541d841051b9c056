"""The port's sharded-scan overhead tool (``eve_tpu_torch.bench.temporal``)
against eve_tpu's ``bench_temporal.py``, on the CPU.

Two gloo CPU ranks at T = 8, B = 2, F = 8: each rank's block of the
sharded outputs equals the plain loop's (the tool's own check), the plain
loop's equal eve_tpu's ``jax.lax.scan`` of the same cell on the same numpy
inputs within rtol 1e-6, and ``main`` prints eve_tpu's keys (a count that does not divide T skipped, as eve_tpu
skips it). A rank that fails fails the tool.
"""

import argparse
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eve_tpu_torch.bench import temporal

T, B, F = 8, 2, 8


def eve_tpu_scan():
    """bench_temporal.py's cell, inputs and ``lax.scan`` (variant 0)."""
    rng = np.random.RandomState(0)
    W = jnp.asarray(rng.randn(F, F) * 0.1, jnp.float32)
    xs_host = rng.randn(T, B, F).astype(np.float32)
    carry0 = jnp.zeros((B, F), jnp.float32)

    def cell(carry, x):
        h = jnp.tanh(carry @ W + x)
        return h, h

    _, ys = jax.lax.scan(cell, carry0, jnp.asarray(xs_host + 0))
    return np.asarray(ys)


def test_sharded_scan_matches_eve_tpus_and_prints_its_keys():
    """Each of the 2 ranks holds its block of the sharded outputs to equal
    the plain loop's bit for bit before it times; the plain loop on the
    tool's inputs equals eve_tpu's ``lax.scan``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = temporal.main(['--device', 'cpu', '--T', str(T), '--batch',
                            str(B), '--features', str(F), '--iters', '2',
                            '--shards', '2', '3'])
    assert rc == 0
    (line,) = out.getvalue().splitlines()
    line = json.loads(line)
    assert set(line) == {'plain_scan_ms', 'sharded_scan_2_ms', 'overhead_2x',
                         'metric', 'T', 'card'}
    assert line['metric'] == 'sharded_scan_overhead_proxy'
    assert line['T'] == T and line['card'] == 'cpu'
    assert line['plain_scan_ms'] > 0 and line['sharded_scan_2_ms'] > 0
    # The ratio of the unrounded times, beside that of the rounded ones.
    assert line['overhead_2x'] == pytest.approx(
        line['sharded_scan_2_ms'] / line['plain_scan_ms'], rel=0.05)

    args = argparse.Namespace(T=T, batch=B, features=F)
    cell, carry0, variants = temporal.device_inputs(args, 'cpu')
    with torch.no_grad():
        _, plain = temporal.plain_scan(cell, carry0, variants[0])
    assert plain.shape == (T, B, F)
    np.testing.assert_allclose(plain.numpy(), eve_tpu_scan(), rtol=1e-6)


def test_the_inputs_are_eve_tpus():
    W, xs = temporal.scan_inputs(T, B, F)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        W, np.asarray(jnp.asarray(rng.randn(F, F) * 0.1, jnp.float32)))
    np.testing.assert_array_equal(xs, rng.randn(T, B, F).astype(np.float32))


def test_a_failing_rank_fails_the_tool():
    """Both ranks ask for a card that is not there: the tool raises with
    a rank's traceback, after stopping the ranks."""
    args = argparse.Namespace(device='cuda', T=T, batch=B, features=F,
                              iters=1)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match='no CUDA card is visible'):
        temporal.time_sharded(args, 2)
