"""Data-parallel training of the port over gloo on the CPU, against eve_tpu.

Spawned processes (``tests/torch_parallel_child.py``) write their results
to files; each spawned test has a time limit of its own.

- Two ranks, each on its 2 rows of a batch of 4 (``configs/refine_net.json``
  with a frozen EyeNet, 32x32 eyes, T = 3, eve_tpu's perturbed weights and
  injected kappas, as in ``tests/test_torch_train_step.py``): 2
  ``train_step``s, one ``multi_source_train_step`` of two sources and one
  update accumulated over 2 micro-batches, against eve_tpu's steps on a
  2-device mesh (the sharded step's loss and gradient, jitted once, with
  parameters replicated and the batch sharded as ``tests/test_parallel.py``
  shards them, then eve_tpu's optax chain; two sources through the sum of
  their gradients, accumulation through optax ``MultiSteps``), at
  ``test_torch_train_step.py``'s tolerances: the first ``full_loss`` rtol
  1e-5, the parameters after each update as its ``assert_updates_agree``
  holds them (every element within twice the step bound, 99% within 10% of
  it). As there, only the first step's ``full_loss`` is held: the second
  one's parameters agree within the update tolerance, and Adam moves an
  element whose gradient lies within rounding of 0 either way (measured:
  2.7e-4 relative). Both ranks hold bitwise equal parameters.
- Two torchrun-style ranks through ``cli.train.run`` (B = 4, 12 clips, two
  epochs, checkpoints and live validation every 4 steps, a ragged live
  validation and final test) against the port's one-process run of the
  same seed: the ranks' rows of every batch are the one process's batch,
  clip for clip; each step's ``full_loss`` (averaged over the ranks) within
  rtol 1e-5; the live validation and final test scalars within rtol 1e-5;
  the final parameters as above; only rank 0 writes checkpoints and logs.
- SIGTERM to rank 1 only: both ranks exit 143 at the same step (the
  agreement every 8 steps), with rank 0's checkpoint, and the same command
  with ``--auto-resume yes`` continues from it on both ranks.
- ``cli.train.run`` with ``tpu_num_devices`` 2 on the CPU starts two
  workers and exits 0; a failing worker makes it exit non-zero.
- ``tpu_multihost`` with the coordinator keys starts a two-process group
  (as ``tests/test_multihost.py`` does for eve_tpu): ranks, hosts,
  ``local_data_slice``, the broadcasts, the flag all-gather and the
  all-reduce.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from eve_tpu.models import eve as jeve
from eve_tpu.parallel import mesh as jmesh
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import optim as optim_lib
from eve_tpu_torch.utils import convert
from eve_tpu_torch.utils.checkpoint import available_checkpoints, load_params
from tests import test_torch_train_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EYES = 32
CHILD_TIMEOUT_S = 420


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(mode, args, log_path, env=None):
    child_env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT',
                'LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
        child_env.pop(key, None)
    child_env.update(env or {})
    log = open(log_path, 'w')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'tests.torch_parallel_child', mode,
         json.dumps(args)], cwd=ROOT, env=child_env, stdout=log,
        stderr=subprocess.STDOUT)
    proc.log_path = log_path
    return proc


def _wait(procs, timeout=CHILD_TIMEOUT_S):
    """Exit codes of ``procs``; kills them all past ``timeout``."""
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes


def _log(proc):
    with open(proc.log_path) as f:
        return f.read()


def _torchrun(world, port):
    return [{'RANK': str(r), 'WORLD_SIZE': str(world),
             'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port)}
            for r in range(world)]


# ----------------------------------------------------------------------
# The step against eve_tpu's sharded step
# ----------------------------------------------------------------------

def _sharded_gradients(jspec):
    """eve_tpu's loss and gradient of the train step (``jax.value_and_grad``
    of ``forward(training=True)['full_loss']``), jitted once, on a batch
    sharded over a 2-device mesh with the parameters replicated, as
    ``tests/test_parallel.py``'s sharded step runs it; GSPMD all-reduces
    the gradient. Returns ``fn(params, batch) -> (loss, grads)``."""
    mesh = jmesh.make_mesh(2)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jeve.forward(jspec, p, b, training=True)['full_loss']))
    return lambda params, batch: grad_fn(jmesh.replicate(mesh, params),
                                         jmesh.shard_batch(mesh, batch))


def _optax_steps(tx, params, grads_of):
    """eve_tpu's update (``tx.update``, then ``params + updates``) after
    each gradient ``grads_of(params)`` yields; the parameters after each,
    as port state dicts of numpy arrays."""
    @jax.jit
    def apply(p, opt_state, grads):
        upd, opt_state = tx.update(grads, opt_state, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), opt_state

    opt_state = tx.init(params)
    after = []
    for grads in grads_of:
        params, opt_state = apply(params, opt_state, grads(params))
        after.append({k: v.numpy() for k, v in convert.eve_state_dict(
            jax.tree_util.tree_map(np.asarray, params)).items()})
    return after


def _assert_updated_like(got, want, before, bound, what):
    ts.assert_updates_agree(
        {k: (got[k] - before[k]).numpy() for k in want},
        {k: want[k] - before[k].numpy() for k in want},
        bound, ts.TOLERANCES['refine_net'][2], what)


def test_two_rank_steps_match_eve_tpus_sharded_step(tmp_path):
    json_name, _, overrides = ts.CASES['refine_net']
    overrides = dict(overrides, batch_size=4)
    accum_overrides = dict(overrides, batch_size=8,
                           gradient_accumulation_steps=2)
    jspec, tx, schedule, _ = ts._configs(json_name, overrides)
    _, tx_accum, schedule_accum, _ = ts._configs(json_name, accum_overrides)
    params = ts.initial_params(jspec)
    names = ('batch', 'batch_a', 'batch_b', 'micro0', 'micro1')
    batches = {name: ts.make_batch(seed, EYES, batch_size=4)
               for seed, name in enumerate(names, start=1)}
    before = convert.eve_state_dict(params)
    torch.save(dict(batches, state_dict=before, overrides=overrides,
                    accum_overrides=accum_overrides,
                    updates_per_epoch=ts.UPDATES_PER_EPOCH),
               str(tmp_path / 'inputs.pt'))
    address = '127.0.0.1:%d' % _free_port()
    procs = [_spawn('steps', {'rank': r, 'address': address,
                              'dir': str(tmp_path)},
                    str(tmp_path / ('steps%d.log' % r)))
             for r in range(2)]
    # eve_tpu runs while the ranks do.
    try:
        grad = _sharded_gradients(jspec)
        losses = {}

        def grads(name):
            def fn(p):
                loss, g = grad(p, batches[name])
                losses.setdefault(name, []).append(float(loss))
                return g
            return fn

        ref_after = _optax_steps(tx, params, [grads('batch')] * 2)
        # Two sources: the gradient of the summed full_loss (eve_tpu's
        # make_multi_source_train_step) is the sum of the two gradients.
        multi_after = _optax_steps(tx, params, [
            lambda p: jax.tree_util.tree_map(
                lambda a, b: a + b, grads('batch_a')(p), grads('batch_b')(p))])
        # optax MultiSteps: an update after the second micro-batch.
        accum_after = _optax_steps(tx_accum, params,
                                   [grads('micro0'), grads('micro1')])
    finally:
        codes = _wait(procs)
    assert codes == [0, 0], [_log(p)[-3000:] for p in procs]
    ranks = [torch.load(str(tmp_path / ('rank%d.pt' % r))) for r in range(2)]
    for key in ('params1', 'multi_params', 'accum_params'):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][k]), (key, k)
    ours = ranks[0]
    np.testing.assert_allclose(ours['step0']['full_loss'],
                               losses['batch'][0], rtol=1e-5)
    for i in range(2):
        _assert_updated_like(ours['params%d' % i], ref_after[i], before,
                             sum(schedule(u) for u in range(i + 1)),
                             'after %d two-rank updates' % (i + 1))
    for tag, name in (('a', 'batch_a'), ('b', 'batch_b')):
        np.testing.assert_allclose(ours['multi'][tag + '/full_loss'],
                                   losses[name][0], rtol=1e-5)
    np.testing.assert_allclose(ours['multi']['full_loss'],
                               losses['batch_a'][0] + losses['batch_b'][0],
                               rtol=1e-5)
    _assert_updated_like(ours['multi_params'], multi_after[0], before,
                         schedule(0), 'two sources')
    # The micro-step before the update changes nothing; one update after.
    _assert_updated_like(ours['accum_params'], accum_after[1], before,
                         schedule_accum(0), 'accumulated over 2 micro-steps')


# ----------------------------------------------------------------------
# The harness: two ranks against one process
# ----------------------------------------------------------------------

def _train_overrides(**overrides):
    return dict({
        'eye_net_load_pretrained': False, 'batch_size': 4,
        'max_sequence_len': 3, 'eyes_size': [EYES, EYES],
        'base_learning_rate': 1e-5, 'fully_reproducible': True,
        'num_epochs': 2.0, 'train_data_workers': 0, 'test_data_workers': 0,
        'full_test_data_workers': 0, 'checkpoints_save_every_n_steps': 4,
        'test_every_n_steps': 4, 'test_num_samples': 3,
        'test_batch_size': 2, 'full_test_batch_size': 2,
        'log_every_n_steps': 1}, **overrides)


def _records(directory, names):
    out = []
    for name in names:
        with open(os.path.join(directory, 'record%s.json' % name)) as f:
            out.append(json.load(f))
    return out


def _run_dir(base):
    (run,) = glob.glob(os.path.join(base, 'EVE', '*'))
    return run


def test_two_ranks_train_as_one_process(tmp_path):
    args = {'overrides': _train_overrides(), 'clips': 12, 'val_clips': 3}
    port = _free_port()
    procs = []
    for env in _torchrun(2, port):
        rank_dir = tmp_path / ('rank' + env['RANK'])
        rank_dir.mkdir()
        procs.append(_spawn('train', dict(args, dir=str(rank_dir),
                                          out=str(tmp_path / 'two')),
                            str(rank_dir / 'log'), env))
    one_dir = tmp_path / 'one'
    one_dir.mkdir()
    procs.append(_spawn('train', dict(args, dir=str(one_dir),
                                      out=str(tmp_path / 'one_run')),
                        str(one_dir / 'log')))
    codes = _wait(procs)
    assert codes == [0, 0, 0], [_log(p)[-3000:] for p in procs]
    (rank0,), (rank1,), (one,) = (
        _records(str(tmp_path / d), [r]) for d, r in (
            ('rank0', '0'), ('rank1', '1'), ('one', '0')))
    steps = [str(s) for s in range(6)]
    assert sorted(one['losses'], key=int) == steps
    assert rank0['losses'] == rank1['losses']
    np.testing.assert_allclose([rank0['losses'][s] for s in steps],
                               [one['losses'][s] for s in steps], rtol=1e-5)
    # The ranks' rows of each batch, epoch by epoch: the one process's.
    assert sorted(one['rows']) == ['0', '1']
    for epoch, batches in one['rows'].items():
        for b, clips in enumerate(batches):
            assert rank0['rows'][epoch][b] + rank1['rows'][epoch][b] == clips
    # Live validation at step 4 and the final test (3 clips in batches of
    # 2: ragged), on every rank.
    assert len(one['tests']) == 2
    for rank in (rank0, rank1):
        assert len(rank['tests']) == 2
        for got, want in zip(rank['tests'], one['tests']):
            for k, v in want['val'].items():
                np.testing.assert_allclose(got['val'][k], v, rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    # Only rank 0 writes: checkpoints, messages.log, TensorBoard.
    logs = [_log(p) for p in procs]
    assert '> Saved parameters to' in logs[0]
    assert '> Saved parameters to' not in logs[1]
    run = _run_dir(str(tmp_path / 'two'))
    assert [s for s, _ in available_checkpoints(run)] == [4, 6]
    got = convert.eve_state_dict(load_params(
        available_checkpoints(run)[-1][1]))
    want = convert.eve_state_dict(load_params(available_checkpoints(
        _run_dir(str(tmp_path / 'one_run')))[-1][1]))
    # Both from the seed-0 initialisation, 6 updates of the schedule.
    config = tconfig.Config()
    config.import_json(os.path.join(ROOT, 'configs', 'refine_net.json'))
    config.import_dict(args['overrides'])
    initial = teve.init_model(teve.EveSpec.from_config(config),
                              torch.Generator().manual_seed(0),
                              'cpu').state_dict()
    schedule = optim_lib.make_schedule(config, 3)
    _assert_updated_like(got, {k: v.numpy() for k, v in want.items()},
                         initial, sum(schedule(u) for u in range(6)),
                         'two ranks vs one process')


def test_sigterm_to_one_rank_preempts_both(tmp_path):
    overrides = _train_overrides(batch_size=2, auto_resume=True,
                                 checkpoints_save_every_n_steps=1000,
                                 test_every_n_steps=1000)
    args = {'overrides': overrides, 'clips': 10, 'val_clips': 2,
            'out': str(tmp_path / 'out')}
    logs = []

    def run(sigterm_after, attempt):
        port = _free_port()
        procs = []
        for env in _torchrun(2, port):
            rank_dir = tmp_path / ('%s_rank%s' % (attempt, env['RANK']))
            rank_dir.mkdir()
            procs.append(_spawn('train', dict(args, dir=str(rank_dir),
                                              sigterm_after=sigterm_after),
                                str(rank_dir / 'log'), env))
        codes = _wait(procs)
        logs.append([_log(p) for p in procs])
        return codes, [_records(str(tmp_path / ('%s_rank%d' % (attempt, r))),
                                ['%d' % r])[0] for r in range(2)]

    # Rank 1's fifth clip is read while step 2 runs (the prefetcher holds
    # two batches): past the agreement after step 1.
    codes, records = run(5, 'first')
    assert codes == [143, 143], [log[-3000:] for log in logs[-1]]
    # Both stop at the agreement after step 9 (step index 8), rank 1's
    # signal notwithstanding its arrival a few steps earlier.
    for log, record in zip(logs[-1], records):
        assert 'checkpoint saved at step 9;' in log
        assert sorted(record['losses'], key=int) == [str(s) for s in range(9)]
    assert '> Saved parameters to' not in logs[-1][1]
    run_dir = _run_dir(args['out'])
    assert [s for s, _ in available_checkpoints(run_dir)] == [9]
    codes, records = run(0, 'again')
    assert codes == [0, 0], [log[-3000:] for log in logs[-1]]
    for log, record in zip(logs[-1], records):
        assert 'auto_resume: continuing %s' % run_dir in log
        assert list(record['losses']) == ['9'] and record['final_test']
    assert [s for s, _ in available_checkpoints(run_dir)] == [9, 10]


def test_launcher_starts_workers_and_reports_a_failure(tmp_path):
    overrides = _train_overrides(batch_size=2, num_epochs=1.0,
                                 checkpoints_save_every_n_steps=1000,
                                 test_every_n_steps=1000)
    args = {'overrides': overrides, 'clips': 4, 'val_clips': 2}
    good = _spawn('launch', dict(args, out=str(tmp_path / 'good')),
                  str(tmp_path / 'good.log'))
    bad = _spawn('launch', dict(args, out=str(tmp_path / 'bad'),
                                fail_rank=1), str(tmp_path / 'bad.log'))
    codes = _wait([good, bad])
    assert codes[0] == 0, _log(good)[-3000:]
    assert codes[1] not in (0, 143), _log(bad)[-3000:]
    assert '[worker 1]' in _log(good) and 'Workers exited [0, 0]' in \
        _log(good)
    assert 'rank 1 fails on purpose' in _log(bad)
    run = _run_dir(str(tmp_path / 'good'))
    assert [s for s, _ in available_checkpoints(run)] == [2]


def test_multihost_keys_start_a_two_process_group(tmp_path):
    address = '127.0.0.1:%d' % _free_port()
    procs = [_spawn('multihost', {'host': h, 'address': address,
                                  'dir': str(tmp_path)},
                    str(tmp_path / ('host%d.log' % h))) for h in range(2)]
    codes = _wait(procs)
    assert codes == [0, 0], [_log(p)[-3000:] for p in procs]
    for host in range(2):
        with open(str(tmp_path / ('host%d.json' % host))) as f:
            out = json.load(f)
        assert (out['rank'], out['world'], out['host'], out['hosts']) == (
            host, 2, host, 2)
        assert out['backend'] == 'gloo'
        assert out['slice'] == jmesh.local_data_slice(10, host, 2)
        assert out['name'] == 'run-of-host-0'
        assert out['flags'] == [False, True]
        assert out['mean'] == [1.5] * 3 and out['ones'] == [1.0, 1.0]
        assert out['broadcast'] == [0.0, 0.0]
        assert out['primary'] == (host == 0)
