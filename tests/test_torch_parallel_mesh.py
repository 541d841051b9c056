"""The port's data-parallel layout against eve_tpu's, on the CPU.

- ``make_mesh``: sizes, a repeated device, and the refusal when too few
  devices exist (no CUDA card here);
- ``shard_batch``: the rows each device gets, against the rows of each
  device's shard of eve_tpu's ``shard_batch`` on the virtual CPU mesh;
- ``local_data_slice``: eve_tpu's wrap-around rule for several (items,
  hosts);
- the clips each rank reads (``DataLoader(shard=)``), over two epochs and
  a resume with ``fast_forward``: on one host, the ranks' rows of each
  batch together are eve_tpu's one-loader batch, clip for clip, for 2 and
  4 ranks; across two hosts, each host's ranks together read eve_tpu's
  per-host loader over its ``local_data_slice``;
- a ragged eval batch: each rank's real rows (``shard_rows``);
- the kappas: the ranks' rows of ``with_rank_kappas`` together are the
  one-process draw;
- ``gather_rows`` and the launcher's spawn-or-not rule
  (``cli.train.worker_count``).
"""

import logging
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu.data.loader import DataLoader as JDataLoader
from eve_tpu.parallel import mesh as jmesh
from eve_tpu_torch.cli import train as train_cli
from eve_tpu_torch.data.loader import DataLoader
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.parallel import mesh as tmesh
from eve_tpu_torch.train import harness


def test_make_mesh():
    mesh = tmesh.make_mesh(devices=['cpu'] * 3)
    assert mesh.size == 3 and mesh.shape == {'data': 3}
    assert mesh.axis_names == ('data',)
    assert tmesh.make_mesh(2, devices=['cpu'] * 3).size == 2
    with pytest.raises(ValueError, match='need 4 devices, have 3'):
        tmesh.make_mesh(4, devices=['cpu'] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='need 2 devices, have 0'):
            tmesh.make_mesh(2)
        with pytest.raises(ValueError, match='no CUDA device'):
            tmesh.make_mesh()
    assert tmesh.as_mesh(None) is None
    assert tmesh.as_mesh(2, 'cpu').devices == (torch.device('cpu'),) * 2
    with pytest.raises(TypeError, match='DataMesh'):
        tmesh.as_mesh('two')


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_shard_batch_rows_match_eve_tpus(n):
    rows = 8
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    jax_shards = jmesh.shard_batch(jmesh.make_mesh(n), {'x': jnp.asarray(x)})
    by_device = {s.device.id: np.asarray(s.data)
                 for s in jax_shards['x'].addressable_shards}
    want = [by_device[d.id] for d in jmesh.make_mesh(n).devices.flatten()]
    got = tmesh.shard_batch(tmesh.make_mesh(devices=['cpu'] * n),
                            {'x': torch.from_numpy(x), 'name': 'kept'})
    assert len(got) == n
    for part, ref in zip(got, want):
        np.testing.assert_array_equal(part['x'].numpy(), ref)
        assert part['name'] == 'kept'
    with pytest.raises(ValueError, match='does not divide'):
        tmesh.shard_batch(tmesh.make_mesh(devices=['cpu'] * 3),
                          {'x': torch.zeros(8)})


@pytest.mark.parametrize('items,hosts', [(10, 1), (10, 2), (10, 3), (103, 8),
                                         (7, 4), (4, 4), (3, 5)])
def test_local_data_slice_matches_eve_tpus(items, hosts):
    for host in range(hosts):
        assert tmesh.local_data_slice(items, host, hosts) == \
            jmesh.local_data_slice(items, host, hosts)
    # Without a process group this process is host 0 of 1.
    assert tmesh.local_data_slice(items) == list(range(items))


class _Indexed:
    """A dataset whose clip i is ``{'i': i}``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'i': np.asarray(i)}


def _order(loader, epochs=2, skip=0):
    """The clips of each batch over ``epochs`` epochs, after
    ``fast_forward(skip)``."""
    if skip:
        loader.fast_forward(skip)
    out = []
    for _ in range(epochs):
        out.extend(b['i'].tolist() for b in loader)
    return out


@pytest.mark.parametrize('skip', [0, 5])
@pytest.mark.parametrize('ranks', [2, 4])
def test_ranks_read_eve_tpus_one_loader_order(ranks, skip):
    """One host: rank r reads rows [r*b/n, (r+1)*b/n) of each batch of the
    one-loader (seed, epoch) order, across the epoch boundary and after a
    resume; none shuffles a slice of its own."""
    n, batch = 27, 8
    want = _order(JDataLoader(_Indexed(n), batch, shuffle=True,
                              drop_last=True, num_workers=0, seed=123),
                  skip=skip)
    per_rank = [_order(DataLoader(_Indexed(n), batch, shuffle=True,
                                  drop_last=True, num_workers=0, seed=123,
                                  shard=(r, ranks)), skip=skip)
                for r in range(ranks)]
    per_epoch = n // batch
    assert len(want) == 2 * per_epoch - skip % per_epoch
    for b, clips in enumerate(want):
        assert [c for rank in per_rank for c in rank[b]] == clips, b
        assert all(len(rank[b]) == batch // ranks for rank in per_rank)


def test_two_hosts_read_eve_tpus_per_host_order():
    """Two hosts of two ranks: each host's clip list is eve_tpu's
    ``local_data_slice`` and its ranks together read eve_tpu's per-host
    loader (batch_size / hosts clips a batch)."""
    n, batch, hosts, ranks = 21, 8, 2, 2
    for host in range(hosts):
        idx = jmesh.local_data_slice(n, host, hosts)
        want = _order(JDataLoader(_HostClips(idx), batch // hosts,
                                  shuffle=True, drop_last=True,
                                  num_workers=0, seed=9))
        per_rank = [_order(DataLoader(harness.HostSlice(
            _Indexed(n), tmesh.local_data_slice(n, host, hosts)),
            batch // hosts, shuffle=True, drop_last=True, num_workers=0,
            seed=9, shard=(r, ranks))) for r in range(ranks)]
        for b, clips in enumerate(want):
            assert [c for rank in per_rank for c in rank[b]] == clips


class _HostClips:
    """eve_tpu's host slicing (``dataset.all_subfolders`` cut to the host's
    indices), on an indexed dataset."""

    def __init__(self, idx):
        self.idx = idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return {'i': np.asarray(self.idx[i])}


def test_ragged_eval_batch_rows():
    """A ragged final batch: each rank gets its share of the rows, the
    missing ones filled with the batch's last clip, and ``shard_rows``
    says how many are real."""
    loaders = [DataLoader(_Indexed(10), 4, num_workers=0, shard=(r, 2))
               for r in range(2)]
    batches = [[b['i'].tolist() for b in loader] for loader in loaders]
    assert batches == [[[0, 1], [4, 5], [8, 9]], [[2, 3], [6, 7], [9, 9]]]
    assert [[loader.shard_rows(i) for i in range(3)] for loader in loaders] \
        == [[2, 2, 2], [2, 2, 0]]
    assert DataLoader(_Indexed(10), 4, num_workers=0).shard_rows(2) == 2
    with pytest.raises(ValueError, match='divide'):
        DataLoader(_Indexed(10), 3, shard=(0, 2))


def test_rank_kappas_are_rows_of_one_draw(monkeypatch):
    """Each rank keeps its rows of the global batch's kappa draw, so the
    ranks together train on the one-process kappas."""
    spec = teve.EveSpec()
    assert spec.refine_net_do_offset_augmentation
    B, T, world = 2, 3, 3
    want = teve.draw_kappas(spec, B * world,
                            harness.kappa_generator(7, 4))
    batch = {'left_eye_patch': torch.zeros(B, T, 3, 4, 4)}
    monkeypatch.setattr(tmesh, 'process_count', lambda: world)
    for rank in range(world):
        monkeypatch.setattr(tmesh, 'process_index', lambda r=rank: r)
        out = harness.with_rank_kappas(spec, batch,
                                       harness.kappa_generator(7, 4))
        for side, kappa in zip(('left', 'right'), want):
            got = out[side + '_kappa_fake']
            assert got.shape == (B, T, 2)
            assert torch.equal(got[:, 1], kappa[rank * B:(rank + 1) * B])
        assert 'left_kappa_fake' not in batch
    monkeypatch.setattr(tmesh, 'process_count', lambda: 1)
    assert harness.with_rank_kappas(spec, batch, None) is batch


def test_gather_rows():
    parts = [{'x': torch.full((2, 3), float(i)), 'loss': torch.tensor(i + 1.),
              'grid': torch.ones(5), 'name': 'a'} for i in range(2)]
    out = tmesh.gather_rows(parts, 2)
    assert out['x'][:, 0].tolist() == [0, 0, 1, 1]
    assert float(out['loss']) == 1.5
    assert out['grid'].shape == (5,) and out['name'] == 'a'
    host = tmesh.gather_rows([{k: v.numpy() for k, v in p.items()
                               if k != 'name'} for p in parts], 2)
    assert host['x'].shape == (4, 3) and float(host['loss']) == 1.5
    assert tmesh.gather_rows(parts[:1], 2) is parts[0]


def _config(**overrides):
    return types.SimpleNamespace(**dict(dict(
        tpu_num_devices=0, tpu_multihost=False, tpu_num_processes=0,
        batch_size=8, gradient_accumulation_steps=1), **overrides))


def test_launcher_spawns_one_worker_a_device(monkeypatch, caplog):
    """``cli.train.worker_count``: eve_tpu's device rule, no spawn under
    torchrun or inside a worker, and no rank wrapped onto another card."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    count = train_cli.worker_count
    assert count(_config(), 'cuda', env={}) == 4
    assert count(_config(tpu_num_devices=2), 'cuda', env={}) == 2
    assert count(_config(tpu_num_devices=1), 'cuda', env={}) is None
    with caplog.at_level(logging.WARNING):
        assert count(_config(batch_size=6), 'cuda', env={}) == 3
    assert 'per-step batch 6 not divisible by 4 devices; using 3' in \
        caplog.text
    # Accumulation and hosts divide the per-step batch first.
    assert count(_config(gradient_accumulation_steps=4), 'cuda',
                 env={}) == 2
    assert count(_config(tpu_multihost=True, tpu_num_processes=2),
                 'cuda', env={}) == 4
    assert count(_config(batch_size=1), 'cuda', env={}) is None
    # Already a rank: torchrun, or a worker this launcher started.
    torchrun = {'RANK': '0', 'WORLD_SIZE': '2', 'MASTER_ADDR': 'h',
                'MASTER_PORT': '1'}
    assert count(_config(), 'cuda', env=torchrun) is None
    assert count(_config(), 'cuda', env={'LOCAL_RANK': '1'}) is None
    # The CPU: one device unless asked for more (the tests' gloo ranks).
    assert count(_config(), 'cpu', env={}) is None
    assert count(_config(tpu_num_devices=2), 'cpu', env={}) == 2
    with pytest.raises(ValueError, match='need 8 CUDA devices, have 4'):
        count(_config(tpu_num_devices=8), 'cuda', env={})
    with pytest.raises(ValueError, match='names one card'):
        count(_config(tpu_num_devices=2), 'cuda:1', env={})
    assert train_cli.rank_device('cuda', 3) == torch.device('cuda', 3)
    assert train_cli.rank_device('cuda:0', 3) == torch.device('cuda', 0)
    assert train_cli.rank_device('cpu', 3) == torch.device('cpu')


def test_process_group_helpers_without_a_group():
    """Without a group every collective is the identity."""
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    assert tmesh.is_primary_process()
    assert tmesh.broadcast_string('run') == 'run'
    assert tmesh.broadcast_object({'a': 1}) == {'a': 1}
    assert tmesh.all_gather_flags(True) == [True]
    t = [torch.ones(3)]
    assert tmesh.all_reduce_mean_(t)[0].tolist() == [1, 1, 1]
    state = {'w': torch.ones(2)}
    host = tmesh.gather_to_host(state)
    assert host['w'] is not state['w'] and torch.equal(host['w'], state['w'])
    assert tmesh.gather_to_host(state, skip_local=True) is state
    with pytest.raises(ValueError, match='coordinator address'):
        tmesh.initialize_multihost()


def test_batches_split_over_the_world(monkeypatch):
    """Under a given world a per-step batch that does not divide by the
    ranks raises; eval loaders split their batches over the ranks when
    they divide, else every rank evaluates them whole."""
    import signal

    from tests.torch_clips import specs

    from eve_tpu_torch import config as tconfig
    # init_datasets would arm the preemption handler in this process.
    monkeypatch.setattr(signal, 'signal', lambda *args: None)
    cfg = tconfig.Config()
    cfg.import_dict({'batch_size': 4, 'max_sequence_len': 2,
                     'eyes_size': [16, 16], 'train_data_workers': 0})
    monkeypatch.setattr(tmesh, 'local_world_size', lambda: 3)
    with pytest.raises(ValueError, match='1 hosts x 3 workers'):
        harness.init_datasets(cfg, [specs('train', 0, 8)], [])
    monkeypatch.setattr(tmesh, 'local_world_size', lambda: 2)
    monkeypatch.setattr(tmesh, 'local_rank', lambda: 1)
    train, _ = harness.init_datasets(cfg, [specs('train', 0, 8)], [])
    assert train['train']['dataloader'].shard == (1, 2)
    monkeypatch.setattr(tmesh, 'process_count', lambda: 2)
    monkeypatch.setattr(tmesh, 'process_index', lambda: 1)
    assert harness.SubsetLoader(_Indexed(5), None, 4).shard == (1, 2)
    assert harness.SubsetLoader(_Indexed(5), None, 3).shard is None
