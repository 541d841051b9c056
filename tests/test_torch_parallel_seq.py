"""The grid's seq axis (sequence-sharded recurrences) of the port over gloo
on the CPU, against eve_tpu on its 8-device virtual CPU mesh.

Spawned ranks (``tests/torch_parallel_child.py`` ``grid`` and ``scan``)
write their results to files; each spawned test has a time limit of its
own. Sizes are ``tests/test_torch_parallel_train.py``'s: 32x32 eyes,
T = 4, B = 4, eve_tpu's perturbed weights and injected kappas.

- seq = 2 for ``configs/eye_net.json`` (a GRU carry's gradient crosses the
  ranks) and ``configs/refine_net.json`` (the CLSTM's), and data 2 x seq 2
  on four ranks for ``configs/refine_net.json``: one update of the port's
  ``train_step`` on each rank's rows and frames against eve_tpu's
  ``make_train_step(seq_mesh=make_mesh_nd(...))`` and its single-device
  step (each jitted once in the module): the updated parameters within
  ``test_torch_train_step``'s ``assert_updates_agree`` of both, and equal
  on every rank; the first ``full_loss`` (every rank holds the whole
  clips' loss) within rtol 1e-5 of the port's one-process step, the
  sharding's own error, and within rtol 1e-4 of eve_tpu's steps, eve_tpu's
  own tolerance for its sharded step against its single one
  (``tests/test_parallel.py``): one pixel of the batch's refined heatmap
  lies at float32's sigmoid saturation, and the frameworks round it to
  either side of 1.0, where the BCE's log is clamped at -100 (measured:
  the port's one process 5.766335, eve_tpu's single device 5.765767,
  eve_tpu's own model 2 x seq 2 step 5.766336; 9.9e-5 relative). The
  seq-sharded eval forward's scalars and final states (replicated over
  the axis) against the port's unsharded forward, within rtol 1e-5 (the
  states plus 1e-4 absolute: a rank encodes half the frames, which oneDNN
  blocks and rounds otherwise, and the CLSTM state carries that through
  the clip; measured 3.7e-5 in states of magnitude ~1).
- ``temporal.sharded_scan`` of a GRU-like step (over seq = 2, and data 2 x
  seq 2 with ``batch_axis``) against eve_tpu's ``sharded_scan`` and a
  plain loop: outputs, final carry and input gradients; and its checks
  (the ValueErrors for a non-uniform batch, a rank-0 carry and a batch
  that does not divide, and the assertion that the axis divides T) raise
  eve_tpu's messages.
- The grid's ValueErrors (``harness.training_grid``) are eve_tpu's
  ``Experiment``'s, word for word, and ``cli.train.worker_count`` starts
  the whole grid.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import eve as jeve
from eve_tpu.parallel import mesh as jmesh
from eve_tpu.parallel import temporal as jtemporal
from eve_tpu.train import harness as jharness
from eve_tpu.train import step as jstep
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.cli import train as train_cli
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.parallel import mesh as tmesh
from eve_tpu_torch.parallel import temporal
from eve_tpu_torch.train import harness
from eve_tpu_torch.utils import convert
from tests import test_torch_parallel_train as tpt
from tests import test_torch_train_step as ts

EYES, T, B = 32, 4, 4
CHILD_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def drop_big_files(directory, limit=1 << 20):
    """Remove the files over ``limit`` bytes under ``directory`` (weights,
    checkpoints, the ranks' results); the logs stay. The suite's temporary
    directories share one disk."""
    for root, _, files in os.walk(str(directory)):
        for name in files:
            path = os.path.join(root, name)
            if os.path.getsize(path) > limit:
                os.remove(path)


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    yield
    drop_big_files(tmp_path)


def make_batch(seed, batch_size=B, sigma=3.0):
    """A numpy batch of ``batch_size`` clips of T frames, kappas injected."""
    rng = np.random.RandomState(seed)
    batch = make_synthetic_batch(rng, batch_size=batch_size, sequence_len=T,
                                 eyes_size=EYES, frame_dtype=np.uint8)
    for side in ('left', 'right'):
        kappa = np.radians(sigma) * rng.normal(size=(batch_size, 2))
        batch[side + '_kappa_fake'] = np.repeat(
            kappa[:, None].astype(np.float32), T, axis=1)
    return batch


def case(name):
    """``(json name, overrides, eve_tpu spec, optax chain, schedule)``."""
    json_name, _, overrides = ts.CASES[name]
    overrides = dict(overrides, batch_size=B, max_sequence_len=T,
                     eyes_size=[EYES, EYES])
    jspec, tx, schedule, _ = ts._configs(json_name, overrides)
    return json_name, overrides, jspec, tx, schedule


_STEPS = {}


def eve_tpu_step(jspec, tx, params, batch, axes=None):
    """eve_tpu's ``make_train_step`` (on ``make_mesh_nd(axes)`` when given:
    the batch sharded over 'data', the parameters and Adam's moments over
    'model' with ``shard_model_tree(min_size=0)``) from ``params``:
    ``(full_loss, parameters after the update as a port state dict)``."""
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params))
    seq_mesh, jbatch = None, {k: jnp.asarray(v) for k, v in batch.items()}
    if axes:
        mesh = jmesh.make_mesh_nd(axes)
        seq_mesh = mesh if 'seq' in axes else None
        if 'model' in axes:
            state = state.replace(
                params=jmesh.shard_model_tree(mesh, state.params, min_size=0),
                opt_state=jmesh.shard_model_tree(mesh, state.opt_state,
                                                 min_size=0))
        if 'data' in axes:
            jbatch = jmesh.shard_batch(mesh, jbatch)
    # Jitted once in the module for each configuration and grid.
    key = (jspec, tuple((axes or {}).items()))
    if key not in _STEPS:
        _STEPS[key] = jstep.make_train_step(jspec, tx, donate=False,
                                            seq_mesh=seq_mesh)
    new, metrics = _STEPS[key](state, jbatch, jax.random.PRNGKey(0))
    return float(metrics['full_loss']), {
        k: v.numpy() for k, v in convert.eve_state_dict(
            jax.tree_util.tree_map(np.asarray, new.params)).items()}


def spawn_grid(tmp_path, axes, inputs, extra=None, name='grid'):
    """The ranks of ``axes`` (``grid`` mode) started together; returns
    their processes (``wait_grid`` reads them)."""
    world = int(np.prod(list(axes.values())))
    torch.save(inputs, str(tmp_path / 'inputs.pt'))
    address = '127.0.0.1:%d' % tpt._free_port()
    return [tpt._spawn('grid', dict({'rank': r, 'world': world,
                                     'address': address, 'axes': axes,
                                     'dir': str(tmp_path), 'min_size': 0},
                                    **(extra or {})),
                       str(tmp_path / ('%s%d.log' % (name, r))))
            for r in range(world)]


def wait_grid(tmp_path, procs):
    codes = tpt._wait(procs, CHILD_TIMEOUT_S)
    assert codes == [0] * len(procs), [tpt._log(p)[-3000:] for p in procs]
    return [torch.load(str(tmp_path / ('rank%d.pt' % r)), weights_only=False)
            for r in range(len(procs))]


def assert_step_like(ranks, want_loss, want_params, before, bound, name,
                     what, rtol=1e-4):
    """Every rank's loss within ``rtol`` of ``want_loss`` (see the module
    docstring) and its parameters after the update within the Adam-update
    rule; the ranks' parameters equal."""
    for r in ranks:
        np.testing.assert_allclose(r['metrics']['full_loss'], want_loss,
                                   rtol=rtol, err_msg=what)
        for k, v in ranks[0]['params'].items():
            assert torch.equal(v, r['params'][k]), (what, k)
    got = ranks[0]['params']
    ts.assert_updates_agree(
        {k: (got[k] - before[k]).numpy() for k in want_params},
        {k: want_params[k] - before[k].numpy() for k in want_params},
        bound, ts.TOLERANCES[name][2], what)


def port_forwards(json_name, overrides, state_dict, batch):
    """The port's one-process training forward's ``full_loss``, and its
    unsharded eval forward: ``(full_loss, scalars, final states)``."""
    tc = tconfig.Config()
    tc.import_json(os.path.join(ts.CONFIGS, json_name))
    tc.import_dict(overrides)
    model = teve.build_model(teve.EveSpec.from_config(tc), state_dict, 'cpu')
    tbatch = teve.batch_to_tensors(batch, 'cpu')
    with torch.no_grad():
        loss = float(model(tbatch, training=True)['full_loss'])
        out = model(tbatch, return_states=True)
    return loss, ({k: float(v) for k, v in out.items()
                   if torch.is_tensor(v) and v.ndim == 0}, out['states'])


# ----------------------------------------------------------------------
# The train step on the grid against eve_tpu's sharded step
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name', ['eye_net', 'refine_net'])
def test_seq_step_matches_eve_tpu(name, tmp_path):
    json_name, overrides, jspec, tx, schedule = case(name)
    params = ts.initial_params(jspec)
    batch = make_batch(1)
    before = convert.eve_state_dict(params)
    procs = spawn_grid(tmp_path, {'data': 1, 'seq': 2}, {
        'state_dict': before, 'batch': batch, 'overrides': overrides,
        'json_name': json_name, 'updates_per_epoch': ts.UPDATES_PER_EPOCH},
        {'eval': True})
    try:  # eve_tpu runs while the ranks do
        sharded = eve_tpu_step(jspec, tx, params, batch, {'seq': 2})
        single = eve_tpu_step(jspec, tx, params, batch)
        one, (scalars, states) = port_forwards(json_name, overrides, before,
                                               batch)
    finally:
        ranks = wait_grid(tmp_path, procs)
    assert [r['coords'] for r in ranks] == [{'data': 0, 'seq': 0},
                                            {'data': 0, 'seq': 1}]
    for (loss, after), what in ((sharded, 'vs eve_tpu seq=2'),
                                (single, 'vs eve_tpu one device')):
        assert_step_like(ranks, loss, after, before, schedule(0), name, what)
    for r in ranks:
        np.testing.assert_allclose(r['metrics']['full_loss'], one, rtol=1e-5)
    # The seq-sharded eval forward holds the whole clips' scalars, and the
    # final states, replicated over the axis, are the whole clips'.
    for r in ranks:
        for k, v in scalars.items():
            np.testing.assert_allclose(r['eval'][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        got = temporal._flatten(r['states'])[0]
        want = temporal._flatten(states)[0]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-4)


def test_data2_seq2_step_matches_eve_tpu(tmp_path):
    name = 'refine_net'
    json_name, overrides, jspec, tx, schedule = case(name)
    params = ts.initial_params(jspec)
    batch = make_batch(1)
    before = convert.eve_state_dict(params)
    procs = spawn_grid(tmp_path, {'data': 2, 'seq': 2}, {
        'state_dict': before, 'batch': batch, 'overrides': overrides,
        'json_name': json_name, 'updates_per_epoch': ts.UPDATES_PER_EPOCH})
    try:
        sharded = eve_tpu_step(jspec, tx, params, batch,
                               {'data': 2, 'seq': 2})
        single = eve_tpu_step(jspec, tx, params, batch)
        one, _ = port_forwards(json_name, overrides, before, batch)
    finally:
        ranks = wait_grid(tmp_path, procs)
    assert [r['coords'] for r in ranks] == [
        {'data': d, 'seq': s} for d in range(2) for s in range(2)]
    for (loss, after), what in ((sharded, 'vs eve_tpu data 2 x seq 2'),
                                (single, 'vs eve_tpu one device')):
        assert_step_like(ranks, loss, after, before, schedule(0), name, what)
    for r in ranks:
        np.testing.assert_allclose(r['metrics']['full_loss'], one, rtol=1e-5)


# ----------------------------------------------------------------------
# sharded_scan
# ----------------------------------------------------------------------

SCAN_T, SCAN_B, SCAN_F = 8, 4, 3


def _scan_inputs():
    rng = np.random.RandomState(0)
    return {'W': (rng.randn(SCAN_F, SCAN_F) * 0.5).astype(np.float32),
            'xs': {'u': rng.randn(SCAN_T, SCAN_B, SCAN_F).astype(np.float32),
                   'gate': rng.rand(SCAN_T, SCAN_B, 1).astype(np.float32)},
            'carry': {'h': rng.randn(SCAN_B, SCAN_F).astype(np.float32),
                      'count': np.zeros((SCAN_B,), np.float32)}}


def _eve_tpu_scan(inputs, axes):
    """eve_tpu's ``sharded_scan`` of the child's step: outputs, final
    carry and the gradient of the same sum with respect to xs."""
    mesh = jmesh.make_mesh_nd(axes)
    W = jnp.asarray(inputs['W'])

    def step(carry, x):
        h = jnp.tanh(carry['h'] @ W + x['u']) * x['gate'] + \
            carry['h'] * (1 - x['gate'])
        return ({'h': h, 'count': carry['count'] + 1.0},
                {'out': h * 2.0, 'norm': jnp.sum(h ** 2, axis=-1)})

    batch_axis = 'data' if 'data' in axes else None

    def total(xs):
        carry, ys = jtemporal.sharded_scan(
            step, jax.tree_util.tree_map(jnp.asarray, inputs['carry']), xs,
            mesh, batch_axis=batch_axis)
        return jnp.sum(ys['out']) + jnp.sum(ys['norm']), (carry, ys)

    xs = jax.tree_util.tree_map(jnp.asarray, inputs['xs'])
    (_, (carry, ys)), grad = jax.value_and_grad(total, has_aux=True)(xs)
    tree = jax.tree_util.tree_map(np.asarray, (carry, ys, grad))
    return tree


@pytest.mark.parametrize('axes', [{'seq': 2}, {'data': 2, 'seq': 2}],
                         ids=['seq2', 'data2_seq2'])
def test_sharded_scan_matches_eve_tpus(axes, tmp_path):
    inputs = _scan_inputs()
    torch.save(jax.tree_util.tree_map(torch.from_numpy, inputs),
               str(tmp_path / 'scan.pt'))
    world = int(np.prod(list(axes.values())))
    address = '127.0.0.1:%d' % tpt._free_port()
    procs = [tpt._spawn('scan', {'rank': r, 'world': world,
                                 'address': address, 'axes': axes,
                                 'dir': str(tmp_path)},
                        str(tmp_path / ('scan%d.log' % r)))
             for r in range(world)]
    try:
        carry, ys, grad = _eve_tpu_scan(inputs, axes)
    finally:
        codes = tpt._wait(procs, CHILD_TIMEOUT_S)
    assert codes == [0] * world, [tpt._log(p)[-3000:] for p in procs]
    nd = axes.get('data', 1)
    per_t, per_b = SCAN_T // 2, SCAN_B // nd
    for r in range(world):
        out = torch.load(str(tmp_path / ('scan%d.pt' % r)))
        d, s = out['coords'].get('data', 0), out['coords']['seq']
        ts_, bs = slice(s * per_t, (s + 1) * per_t), slice(d * per_b,
                                                            (d + 1) * per_b)
        for k in ys:
            np.testing.assert_allclose(out['ys'][k].numpy(), ys[k][ts_, bs],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        for k in grad:
            np.testing.assert_allclose(out['grad'][k][ts_, bs].numpy(),
                                       grad[k][ts_, bs], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        # The final carry of the rank's rows, replicated over seq.
        np.testing.assert_allclose(out['carry']['h'].numpy(),
                                   carry['h'][bs], rtol=1e-5, atol=1e-6)
        assert out['carry']['count'].tolist() == [SCAN_T] * per_b


def _grid_without_group(shape):
    """A rank grid of ``shape`` seen from rank 0, built without a process
    group (the checks run before any collective)."""
    names = list(shape)
    axes = {n: tmesh.Axis(n, 0, shape[n], range(shape[n]), None)
            for n in names}
    return tmesh.RankGrid(shape, 0, axes, None)


SCAN_CHECKS = {
    'mixed batch': ({'a': (4, 4, 3), 'b': (4, 3, 3)}, (4, 3), 'data'),
    'rank-0 carry': ({'a': (4, 4, 3)}, (), 'data'),
    'batch not divisible': ({'a': (4, 3, 3)}, (3, 3), 'data'),
    'T not divisible': ({'a': (3, 4, 3)}, (4, 3), None),
}


@pytest.mark.parametrize('check', sorted(SCAN_CHECKS))
def test_sharded_scan_checks_are_eve_tpus(check):
    xs_shapes, carry_shape, batch_axis = SCAN_CHECKS[check]
    mesh = jmesh.make_mesh_nd({'data': 2, 'seq': 2})
    grid = _grid_without_group({'data': 2, 'seq': 2})
    errors = []
    for package in ('eve_tpu', 'port'):
        zeros = jnp.zeros if package == 'eve_tpu' else torch.zeros
        xs = {k: zeros(v) for k, v in xs_shapes.items()}
        carry = zeros(carry_shape)
        with pytest.raises((ValueError, AssertionError)) as info:
            if package == 'eve_tpu':
                jtemporal.sharded_scan(lambda c, x: (c, c), carry, xs, mesh,
                                       batch_axis=batch_axis)
            else:
                temporal.sharded_scan(lambda c, x: (c, c), carry, xs, grid,
                                      batch_axis=batch_axis)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


# ----------------------------------------------------------------------
# The grid's arithmetic
# ----------------------------------------------------------------------

GRID_ERRORS = {
    'more than the devices': {'tpu_model_parallelism': 3,
                              'tpu_sequence_shards': 3},
    'not a divisor': {'tpu_model_parallelism': 3},
    'T not divisible': {'tpu_sequence_shards': 4},
}


@pytest.mark.parametrize('group', sorted(GRID_ERRORS))
def test_grid_errors_are_eve_tpus(group, tmp_path):
    overrides = dict(GRID_ERRORS[group], tpu_num_devices=8)
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_dict(overrides)
        with pytest.raises(ValueError) as theirs:
            jharness.Experiment(jc, output_dir_base=str(tmp_path))
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_dict(overrides)
    with pytest.raises(ValueError) as ours:
        harness.training_grid(tc, 8)
    assert str(ours.value) == str(theirs.value)
    # An Experiment of one process raises for any grid of several ranks.
    with pytest.raises(ValueError, match='needs|divide'):
        harness.Experiment(tc, str(tmp_path), device='cpu')


def test_launcher_starts_the_whole_grid(monkeypatch):
    """The model and seq axes claim their cards first and the data axis
    takes eve_tpu's largest divisor of the rest; ``worker_count`` starts
    them all, and none under torchrun."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 8)

    def config(**overrides):
        tc = tconfig.Config()
        tc.import_dict(dict({'batch_size': 8, 'max_sequence_len': 30},
                            **overrides))
        return tc

    count = train_cli.worker_count
    assert count(config(tpu_sequence_shards=2), 'cuda', env={}) == 8
    assert harness.training_grid(config(tpu_sequence_shards=2), 8) == {
        'data': 4, 'seq': 2}
    assert harness.training_grid(
        config(tpu_sequence_shards=2, tpu_model_parallelism=2), 8) == {
            'data': 2, 'model': 2, 'seq': 2}
    # 6 devices for data and a batch of 4: a data axis of 4 of them.
    assert harness.training_grid(config(batch_size=4), 6) == {'data': 4}
    assert count(config(tpu_model_parallelism=2, batch_size=1,
                        tpu_num_devices=2), 'cuda', env={}) == 2
    assert count(config(tpu_model_parallelism=2, tpu_sequence_shards=2,
                        batch_size=1, tpu_num_devices=4), 'cuda',
                 env={}) == 4
    with pytest.raises(ValueError, match='needs 4 devices, have 2'):
        count(config(tpu_model_parallelism=2, tpu_sequence_shards=2,
                     tpu_num_devices=2), 'cuda', env={})
    assert count(config(tpu_sequence_shards=2), 'cuda', env={
        'RANK': '0', 'WORLD_SIZE': '2', 'MASTER_ADDR': 'h',
        'MASTER_PORT': '1'}) is None


def test_local_frames_and_their_checks():
    """A seq rank's frames of every (B, T, ...) entry; a divisor of T is
    asserted with eve_tpu's message; an entry of another length raises."""
    axis = tmesh.Axis('seq', 1, 2, (0, 1), None)
    batch = {'left_eye_patch': torch.arange(24.).reshape(2, 4, 3),
             'timestamps': torch.arange(8.).reshape(2, 4), 'name': 'x'}
    out = temporal.local_frames(batch, axis)
    assert out['left_eye_patch'][:, :, 0].tolist() == [[6, 9], [18, 21]]
    assert out['timestamps'].tolist() == [[2, 3], [6, 7]]
    assert out['name'] == 'x'
    assert temporal.local_frames(batch, None) is batch
    with pytest.raises(AssertionError, match='not divisible by 3 shards'):
        temporal.local_frames(batch, tmesh.Axis('seq', 0, 3, (0, 1, 2), None))
    batch['bad'] = torch.zeros(2, 3)
    with pytest.raises(ValueError, match='bad has 3 frames'):
        temporal.local_frames(batch, axis)
