"""The grid's model axis (sharded parameters with their Adam moments) of the
port over gloo on the CPU, against eve_tpu on its 8-device virtual CPU mesh.

Sizes, weights and tolerances are ``tests/test_torch_parallel_seq.py``'s
(32x32 eyes, T = 4, B = 4, eve_tpu's perturbed weights and injected
kappas; ``full_loss`` within rtol 1e-5 of the port's one process and 1e-4
of eve_tpu's steps, for the saturated pixel that module's docstring
describes; parameters within ``assert_updates_agree``).

- The leaves the port's ``shard_model_tree`` places, and the torch dim of
  each, are eve_tpu's (the rule applies to eve_tpu's shapes, which the
  weight map gives): both shipped configs at full width, at eve_tpu's
  ``min_size`` of 4096 and at 0.
- model 2 x seq 2 on four ranks (``shard_model_tree(min_size=0)``, as
  ``tests/test_parallel.py`` places eve_tpu's) against eve_tpu's
  ``{'model': 2, 'seq': 2}`` step and its single-device step: each rank's
  optimizer holds its half of every sharded trained leaf (and that half's
  Adam moments), the forward's weights are the full ones on every rank.
- The grid's checkpoint (every rank joins the gather of the moments, rank
  0 writes) has one process's layout: eve_tpu's ``CheckpointManager``
  reads its parameters, which agree with the one process's checkpoint, as
  do the moments (within ``test_torch_train_step``'s gradient tolerance),
  in the port's ``optimizer_torch.npz`` and in eve_tpu's
  ``optimizer_0.npz`` alike (the same keys, dtypes, shapes and counts);
  it resumes on another grid (model 2 on two ranks) as one process
  resumes it (the next update's loss within rtol 1e-5, its parameters
  within the Adam-update rule), and that grid's ``optimizer_0.npz``
  agrees with the one process's.
- An ``optimizer_0.npz`` that eve_tpu wrote (after one eve_tpu update)
  resumes on model 2 of two ranks as it resumes in one process (each
  rank slices the moments it owns).
- ``cli.train.run`` on four torchrun-style ranks with
  ``--tpu-model-parallelism 2 --tpu-sequence-shards 2`` trains as one
  process does: each step's ``full_loss`` within rtol 1e-5, the final
  test's scalars too, only rank 0 writes, and the final parameters agree.
"""

import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from eve_tpu.config import DefaultConfig
from eve_tpu.models import eve as jeve
from eve_tpu.parallel import mesh as jmesh
from eve_tpu.train import checkpoint as jckpt
from eve_tpu.train import step as jstep
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.parallel import mesh as tmesh
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.train import optim as optim_lib
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert
from eve_tpu_torch.utils.checkpoint import available_checkpoints, load_params
from tests import test_torch_parallel_seq as tps
from tests import test_torch_parallel_train as tpt
from tests import test_torch_train_step as ts

CONFIGS = ts.CONFIGS


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    yield
    tps.drop_big_files(tmp_path)


# ----------------------------------------------------------------------
# The placement rule
# ----------------------------------------------------------------------

def _eve_tpu_placement(json_name, min_size):
    """``{port name: torch dim}`` of the leaves eve_tpu's
    ``shard_model_tree`` places over a model axis of 2, read through the
    weight map: each placed leaf holds its index along its last dim."""
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(os.path.join(CONFIGS, json_name))
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    shapes = jax.eval_shape(functools.partial(jeve.init_params, jspec),
                            jax.random.PRNGKey(0))

    def marker(x):
        if jmesh.model_sharding_spec(x, 2, min_size=min_size) == \
                jax.sharding.PartitionSpec():
            return np.zeros(x.shape, np.float32)
        return np.broadcast_to(np.arange(1, x.shape[-1] + 1,
                                         dtype=np.float32), x.shape)

    sd = convert.eve_state_dict(jax.tree_util.tree_map(marker, shapes))
    out = {}
    for name, t in sd.items():
        if not t.any():
            continue
        (dim,) = [d for d in range(t.ndim)
                  if t.shape[d] > 1 and torch.diff(t, dim=d).any()]
        out[name] = dim
    return out


@pytest.mark.parametrize('min_size', [4096, 0])
@pytest.mark.parametrize('json_name', ['eye_net.json', 'refine_net.json'])
def test_sharded_leaves_are_eve_tpus(json_name, min_size):
    tc = tconfig.Config()
    tc.import_json(os.path.join(CONFIGS, json_name))
    with torch.device('meta'):
        model = teve.EVE(teve.EveSpec.from_config(tc))
    ours = tmesh.shard_model_tree(2, model, min_size=min_size)
    theirs = _eve_tpu_placement(json_name, min_size)
    assert ours == theirs
    assert len(ours) > 10
    # The dense cells' (gates*H, in) weights keep eve_tpu's layout: their
    # placed dim is torch's last, an input dim; a linear layer's is dim 0.
    assert ours['eye_net.rnn_cells.0.weight_hh'] == 1
    assert ours['eye_net.fc_common.0.weight'] == 0


def test_model_sharding_spec_is_eve_tpus():
    for shape, n, min_size in (((3, 3, 64, 128), 2, 4096), ((7,), 2, 0),
                               ((128, 6), 3, 0), ((64, 64), 2, 4097),
                               ((), 2, 0), ((8, 4), 4, 0)):
        x = jax.ShapeDtypeStruct(shape, np.float32)
        want = tuple(jmesh.model_sharding_spec(x, n, min_size=min_size))
        assert tmesh.model_sharding_spec(shape, n, min_size=min_size) == want


# ----------------------------------------------------------------------
# model 2 x seq 2 against eve_tpu, the checkpoint and its resume
# ----------------------------------------------------------------------

AXES = {'data': 1, 'model': 2, 'seq': 2}


def _port_state(json_name, overrides, state_dict):
    tc = tconfig.Config()
    tc.import_json(os.path.join(CONFIGS, json_name))
    tc.import_dict(overrides)
    model = teve.build_model(teve.EveSpec.from_config(tc), state_dict, 'cpu')
    return tstep.create_train_state(tc, model, ts.UPDATES_PER_EPOCH)


@pytest.fixture(scope='module')
def grid_run(tmp_path_factory):
    """One update of model 2 x seq 2 on four ranks, then a checkpoint;
    eve_tpu's steps and the port's one process (its own checkpoint) run
    while the ranks do."""
    tmp = tmp_path_factory.mktemp('grid')
    name = 'refine_net'
    json_name, overrides, jspec, tx, schedule = tps.case(name)
    params = ts.initial_params(jspec)
    batch, batch2 = tps.make_batch(1), tps.make_batch(3)
    before = convert.eve_state_dict(params)
    inputs = {'state_dict': before, 'batch': batch, 'batch2': batch2,
              'overrides': overrides, 'json_name': json_name,
              'updates_per_epoch': ts.UPDATES_PER_EPOCH}
    procs = tps.spawn_grid(tmp, AXES, inputs,
                           {'save': str(tmp / 'ckpt_grid')})
    try:
        sharded = tps.eve_tpu_step(jspec, tx, params, batch,
                                   {'model': 2, 'seq': 2})
        single = tps.eve_tpu_step(jspec, tx, params, batch)
        one = _port_state(json_name, overrides, before)
        one_metrics = tstep.train_step(one, teve.batch_to_tensors(batch,
                                                                  'cpu'))
        tckpt.CheckpointManager(str(tmp / 'ckpt_one')).save_at_step(1, one)
    finally:
        ranks = tps.wait_grid(tmp, procs)
    yield {'tmp': tmp, 'ranks': ranks, 'sharded': sharded,
           'single': single, 'one': one, 'one_loss':
               float(one_metrics['full_loss']), 'before': before,
           'schedule': schedule, 'name': name, 'jspec': jspec,
           'inputs': inputs}
    tps.drop_big_files(tmp)


def test_model2_seq2_step_matches_eve_tpu(grid_run):
    r = grid_run
    ranks = r['ranks']
    assert [x['coords'] for x in ranks] == [
        {'data': 0, 'model': m, 'seq': s} for m in range(2)
        for s in range(2)]
    for (loss, after), what in ((r['sharded'], 'vs eve_tpu model 2 x seq 2'),
                                (r['single'], 'vs eve_tpu one device')):
        tps.assert_step_like(ranks, loss, after, r['before'],
                             r['schedule'](0), r['name'], what)
    for x in ranks:
        np.testing.assert_allclose(x['metrics']['full_loss'], r['one_loss'],
                                   rtol=1e-5)
    # Each rank's optimizer holds half of every placed trained leaf, cut
    # on its placed dim; the module holds the full weights.
    placed = ranks[0]['placed']
    trained = {n for n, p in r['one'].model.named_parameters()
               if p.requires_grad}
    assert set(ranks[0]['slices']) == set(placed) & trained
    assert len(ranks[0]['slices']) > 10
    for name, shape in ranks[0]['slices'].items():
        full = list(r['before'][name].shape)
        full[placed[name]] //= 2
        assert list(shape) == full, name
        assert ranks[0]['params'][name].shape == r['before'][name].shape


def _optimizer_file(path, name=tckpt.OPTIMIZER_FILE):
    with np.load(os.path.join(path, name)) as data:
        return {k: data[k] for k in data.files}


def _assert_optimizer_files_agree(ours_path, theirs_path, name):
    """Two checkpoints' optimizer files ``name``: the same keys, dtypes and
    shapes, equal integer leaves (counts), and the moments within the
    train-step tests' gradient tolerance (elements within 0.1 of a
    tensor's largest, L2 within 3e-2)."""
    theirs = _optimizer_file(theirs_path, name)
    ours = _optimizer_file(ours_path, name)
    assert sorted(ours) == sorted(theirs)
    elem, l2, _ = ts.TOLERANCES['refine_net']
    for k, v in theirs.items():
        assert (ours[k].dtype, ours[k].shape) == (v.dtype, v.shape), k
        if k.endswith('/step') or v.dtype.kind in 'iu':
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
            continue
        top = np.abs(v).max(initial=0)
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=elem * top + 1e-12, err_msg=k)
        assert np.linalg.norm(ours[k] - v) <= l2 * np.linalg.norm(v) + \
            1e-12, k


def test_model_sharded_checkpoint_is_one_process_layout(grid_run):
    r = grid_run
    (grid_path,) = [p for _, p in available_checkpoints(
        str(r['tmp'] / 'ckpt_grid'))]
    (one_path,) = [p for _, p in available_checkpoints(
        str(r['tmp'] / 'ckpt_one'))]
    assert sorted(os.listdir(grid_path)) == sorted(os.listdir(one_path))
    # eve_tpu reads the grid's checkpoint as one process's.
    template = jstep.TrainState(
        step=jax.numpy.zeros((), jax.numpy.int32),
        params=jax.jit(functools.partial(jeve.init_params, r['jspec']))(
            jax.random.PRNGKey(1)), opt_state={})
    loaded, step = jckpt.CheckpointManager(str(r['tmp'] / 'ckpt_grid')).load(
        grid_path, template)
    assert step == 1
    got = convert.eve_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        loaded.params))
    for k, v in r['ranks'][0]['params'].items():
        assert torch.equal(got[k], v), k
    want = convert.eve_state_dict(load_params(one_path))
    ts.assert_updates_agree(
        {k: (got[k] - r['before'][k]).numpy() for k in want},
        {k: (want[k] - r['before'][k]).numpy() for k in want},
        r['schedule'](0), ts.TOLERANCES['refine_net'][2], 'checkpoint')
    # The gathered moments: one process's keys and shapes, values within
    # the train-step tests' gradient tolerance, in both optimizer files.
    for name in (tckpt.OPTIMIZER_FILE, tckpt.OPTAX_OPTIMIZER_FILE):
        _assert_optimizer_files_agree(grid_path, one_path, name)


def test_model_sharded_checkpoint_resumes_on_another_grid(grid_run, tmp_path):
    """The grid's checkpoint resumed on model 2 of two ranks: each rank
    slices the moments it owns, and the next update is the one process's
    from the same checkpoint."""
    r = grid_run
    procs = tps.spawn_grid(tmp_path, {'data': 1, 'model': 2}, r['inputs'], {
        'resume': str(r['tmp'] / 'ckpt_grid'), 'batch': 'batch2',
        'save': str(tmp_path / 'ckpt')}, name='resume')
    try:
        one = _port_state(r['inputs']['json_name'], r['inputs']['overrides'],
                          r['before'])
        tckpt.CheckpointManager(str(r['tmp'] / 'ckpt_grid')) \
            .load_last_checkpoint(one)
        metrics = tstep.train_step(one, teve.batch_to_tensors(
            r['inputs']['batch2'], 'cpu'))
        tckpt.CheckpointManager(str(tmp_path / 'ckpt_one')).save_at_step(
            2, one)
    finally:
        ranks = tps.wait_grid(tmp_path, procs)
    want = {k: v.numpy() for k, v in one.model.state_dict().items()}
    bound = r['schedule'](0) + r['schedule'](1)
    tps.assert_step_like(ranks, float(metrics['full_loss']), want,
                         r['before'], bound, r['name'], 'resumed', rtol=1e-5)
    assert ranks[0]['slices'] and one.step == 2
    (path,) = [p for s, p in available_checkpoints(str(tmp_path / 'ckpt'))
               if s == 2]
    moments = _optimizer_file(path)
    assert all(float(v) == 2 for k, v in moments.items()
               if k.endswith('/step'))
    (one_path,) = available_checkpoints(str(tmp_path / 'ckpt_one'))
    _assert_optimizer_files_agree(path, one_path[1],
                                  tckpt.OPTAX_OPTIMIZER_FILE)


def test_model_axis_resumes_an_eve_tpu_optimizer_file(grid_run, tmp_path):
    """eve_tpu's checkpoint after one update of its own (an
    ``optimizer_0.npz`` and no port file) resumed on model 2 of two ranks:
    the next update is the one process's from the same checkpoint, and
    the Adam state went on from eve_tpu's (its counts are 2)."""
    r = grid_run
    json_name, overrides, jspec, tx, schedule = tps.case(r['name'])
    params = ts.initial_params(jspec)
    rs = np.random.RandomState(11)
    grads = jax.tree_util.tree_map(
        lambda v: (1e-3 * rs.normal(size=np.shape(v))).astype(np.float32),
        params)
    updates, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params,
                                    updates)
    jckpt.CheckpointManager(str(tmp_path / 'ckpt_eve_tpu')).save_at_step(
        1, jstep.TrainState(step=np.int32(1), params=params,
                            opt_state=opt_state))
    resumed = convert.eve_state_dict(params)
    procs = tps.spawn_grid(tmp_path, {'data': 1, 'model': 2}, r['inputs'], {
        'resume': str(tmp_path / 'ckpt_eve_tpu'), 'batch': 'batch2',
        'save': str(tmp_path / 'ckpt')}, name='resume')
    try:
        one = _port_state(json_name, overrides, r['before'])
        tckpt.CheckpointManager(str(tmp_path / 'ckpt_eve_tpu')) \
            .load_last_checkpoint(one)
        metrics = tstep.train_step(one, teve.batch_to_tensors(
            r['inputs']['batch2'], 'cpu'))
        tckpt.CheckpointManager(str(tmp_path / 'ckpt_one')).save_at_step(
            2, one)
    finally:
        ranks = tps.wait_grid(tmp_path, procs)
    want = {k: v.numpy() for k, v in one.model.state_dict().items()}
    tps.assert_step_like(ranks, float(metrics['full_loss']), want, resumed,
                         schedule(1), r['name'], 'eve_tpu resumed',
                         rtol=1e-5)
    assert ranks[0]['slices'] and one.step == 2
    (path,) = [p for s, p in available_checkpoints(str(tmp_path / 'ckpt'))
               if s == 2]
    (one_path,) = [p for _, p in available_checkpoints(
        str(tmp_path / 'ckpt_one'))]
    optax = _optimizer_file(path, tckpt.OPTAX_OPTIMIZER_FILE)
    assert {int(v) for k, v in optax.items() if k.endswith('count')} == {2}
    _assert_optimizer_files_agree(path, one_path, tckpt.OPTAX_OPTIMIZER_FILE)


# ----------------------------------------------------------------------
# Through cli.train on four torchrun-style ranks
# ----------------------------------------------------------------------

def test_grid_trains_through_cli_train(tmp_path):
    grid = {'tpu_model_parallelism': 2, 'tpu_sequence_shards': 2}
    base = tpt._train_overrides(max_sequence_len=4, num_epochs=1.0,
                                checkpoints_save_every_n_steps=1000,
                                test_every_n_steps=1000)
    args = {'clips': 8, 'val_clips': 3}
    port = tpt._free_port()
    procs = []
    for env in tpt._torchrun(4, port):
        rank_dir = tmp_path / ('rank' + env['RANK'])
        rank_dir.mkdir()
        procs.append(tpt._spawn('train', dict(
            args, overrides=dict(base, **grid), dir=str(rank_dir),
            out=str(tmp_path / 'grid')), str(rank_dir / 'log'), env))
    one_dir = tmp_path / 'one'
    one_dir.mkdir()
    procs.append(tpt._spawn('train', dict(args, overrides=base,
                                          dir=str(one_dir),
                                          out=str(tmp_path / 'one_run')),
                            str(one_dir / 'log')))
    codes = tpt._wait(procs)
    assert codes == [0] * 5, [tpt._log(p)[-3000:] for p in procs]
    records = [tpt._records(str(tmp_path / d), [r])[0] for d, r in (
        ('rank0', '0'), ('rank1', '1'), ('rank2', '2'), ('rank3', '3'),
        ('one', '0'))]
    one = records[-1]
    assert sorted(one['losses'], key=int) == ['0', '1']
    for rec in records[:-1]:
        assert rec['losses'].keys() == one['losses'].keys()
        for s, v in one['losses'].items():
            np.testing.assert_allclose(rec['losses'][s], v, rtol=1e-5)
        for k, v in one['final_test']['val'].items():
            np.testing.assert_allclose(rec['final_test']['val'][k], v,
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    logs = [tpt._log(p) for p in procs]
    assert "Rank grid {'data': 1, 'model': 2, 'seq': 2}" in logs[0]
    assert 'model axis shards' in logs[0]
    assert '> Saved parameters to' in logs[0]
    assert not any('> Saved parameters to' in log for log in logs[1:4])
    (run,) = glob.glob(os.path.join(str(tmp_path / 'grid'), 'EVE', '*'))
    got = convert.eve_state_dict(load_params(available_checkpoints(run)[-1][1]))
    (one_run,) = glob.glob(os.path.join(str(tmp_path / 'one_run'), 'EVE',
                                        '*'))
    want = convert.eve_state_dict(load_params(
        available_checkpoints(one_run)[-1][1]))
    config = tconfig.Config()
    config.import_json(os.path.join(CONFIGS, 'refine_net.json'))
    config.import_dict(base)
    initial = teve.init_model(teve.EveSpec.from_config(config),
                              torch.Generator().manual_seed(0),
                              'cpu').state_dict()
    schedule = optim_lib.make_schedule(config, 2)
    tpt._assert_updated_like(got, {k: v.numpy() for k, v in want.items()},
                             initial, schedule(0) + schedule(1),
                             'model 2 x seq 2 through cli.train')
    with open(os.path.join(run, 'configs', 'combined.json')) as f:
        combined = json.load(f)
    assert (combined['tpu_model_parallelism'],
            combined['tpu_sequence_shards']) == (2, 2)
