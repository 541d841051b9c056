"""Checkpoints of the port against eve_tpu's, on the CPU.

Parameters cross in both directions bitwise: the port writes and eve_tpu's
``CheckpointManager.load`` reads, and the reverse (both store eve_tpu's
flattened float32 tree; the layout conversion only transposes). The port's
own optimizer state resumes exactly, and every checkpoint also holds
eve_tpu's ``optimizer_0.npz`` (``tests/test_torch_optax_export.py``); an
eve_tpu run resumes with its optax state from ``optimizer_0.npz``
(``tests/test_torch_train_moments.py`` holds the continuation against
eve_tpu's in every chain layout), and from the older
``optimizer_0.msgpack`` to the same state, bitwise
(``tests/test_torch_optax_msgpack.py`` holds the decoder). Pruning keeps
the newest ``keep_n``, and an interrupted write (a left-over ``.tmp``
directory) is never read.
"""

import functools
import logging
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu.models import eve as jeve
from eve_tpu.train import checkpoint as jckpt
from eve_tpu.train import step as jstep
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope='module')
def tconf():
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict({'eye_net_load_pretrained': False, 'batch_size': 2,
                    'gradient_accumulation_steps': 2})
    return tc


@pytest.fixture(scope='module')
def jspec(tconf):
    return jeve.EveSpec(refine_net_enabled=True, load_screen_content=True,
                        refine_net_rnn_type='CLSTM', eye_net_frozen=True)


def _state(tconf, seed=0):
    model = teve.init_model(teve.EveSpec.from_config(tconf),
                            torch.Generator().manual_seed(seed), 'cpu')
    return tstep.create_train_state(tconf, model, 4)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_template(jspec):
    params = jax.jit(functools.partial(jeve.init_params, jspec))(
        jax.random.PRNGKey(1))
    return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state={})


def test_port_checkpoint_loads_in_eve_tpu_bitwise(tmp_path, tconf, jspec):
    state = _state(tconf)
    path = tckpt.CheckpointManager(str(tmp_path)).save_at_step(3, state)
    assert sorted(os.listdir(path)) == ['eye_net.npz', 'optimizer_0.npz',
                                        'optimizer_torch.npz',
                                        'refine_net.npz']
    loaded, step = jckpt.CheckpointManager(str(tmp_path)).load(
        path, _jax_template(jspec))
    assert step == 3
    got = _flat(loaded.params)
    want = _flat(convert.eve_params(state.model.state_dict()))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = convert.eve_state_dict(jax.tree_util.tree_map(np.asarray,
                                                         loaded.params))
    for k, v in state.model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_eve_tpu_checkpoint_loads_in_port_bitwise(tmp_path, tconf, jspec,
                                                  caplog):
    from eve_tpu.config import DefaultConfig
    from eve_tpu.train import optim as joptim
    template = _jax_template(jspec)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
            np.float32), template.params)
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        jc.import_dict({'batch_size': 2, 'gradient_accumulation_steps': 2})
        tx, _ = joptim.build_optimizer(jc, 4)
    finally:
        DefaultConfig._reset_instance_for_testing()
    # Step 5 under accumulation 2: one micro-step into an update.
    grads = jax.tree_util.tree_map(
        lambda v: rng.normal(0, 1, v.shape).astype(np.float32), params)
    opt_state = tx.init(params)._replace(mini_step=jnp.int32(1),
                                         acc_grads=grads)
    jckpt.CheckpointManager(str(tmp_path)).save_at_step(
        5, template.replace(params=params, opt_state=opt_state))
    state = _state(tconf)
    with caplog.at_level(logging.INFO):
        step = tckpt.CheckpointManager(str(tmp_path)).load_last_checkpoint(
            state)
    assert step == state.step == 5
    assert 'optimizer_0.npz' in caplog.text
    assert 'fresh optimizer' not in caplog.text
    want = convert.eve_state_dict(params)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    want_grads = convert.eve_state_dict(grads)
    trained = [(n, p) for n, p in state.model.named_parameters()
               if p.requires_grad]
    assert len(state.optimizer.state) == len(trained)
    for n, p in trained:
        assert float(state.optimizer.state[p]['step']) == 0.0
        assert torch.equal(p.grad, want_grads[n]), n

    # The older msgpack form resumes to the same state, bitwise (at step
    # 7, also one micro-step into an update).
    import flax.serialization
    old = os.path.join(str(tmp_path), 'checkpoints', '0000007.ckpt')
    os.rename(os.path.join(str(tmp_path), 'checkpoints', '0000005.ckpt'), old)
    os.remove(os.path.join(old, 'optimizer_0.npz'))
    with open(os.path.join(old, 'optimizer_0.msgpack'), 'wb') as f:
        f.write(flax.serialization.to_bytes(opt_state))
    from_npz = state
    state = _state(tconf)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert tckpt.CheckpointManager(str(tmp_path)).load_last_checkpoint(
            state) == 7
    assert 'optimizer_0.msgpack' in caplog.text
    assert 'fresh optimizer' not in caplog.text
    a = from_npz.optimizer.state_dict()['state']
    b = state.optimizer.state_dict()['state']
    assert a.keys() == b.keys() and len(a) == len(trained)
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)
    for (n, p), (_, q) in zip(from_npz.model.named_parameters(),
                              state.model.named_parameters()):
        assert (p.grad is None) == (q.grad is None), n
        assert p.grad is None or torch.equal(p.grad, q.grad), n


def _batch(seed):
    batch = make_synthetic_batch(np.random.RandomState(seed), batch_size=1,
                                 sequence_len=2, eyes_size=32,
                                 frame_dtype=np.uint8)
    return teve.batch_to_tensors(batch, 'cpu')


def test_optimizer_state_resumes_exactly(tmp_path, tconf):
    """Mid-accumulation too: 3 micro-steps (one update and a half), a save
    in the background, one more micro-step; a fresh state loaded from the
    save takes the same micro-step bitwise."""
    batches = [_batch(s) for s in range(4)]
    gen = functools.partial(torch.Generator().manual_seed)
    state = _state(tconf)
    for i in range(3):
        tstep.train_step(state, batches[i], gen(i))
    manager = tckpt.CheckpointManager(str(tmp_path))
    manager.save_at_step(3, state, wait=False)
    tstep.train_step(state, batches[3], gen(3))
    manager.close()

    resumed = _state(tconf, seed=7)
    assert tckpt.CheckpointManager(str(tmp_path)).load_last_checkpoint(
        resumed) == 3
    assert resumed.step == 3 and resumed.updates == 1
    tstep.train_step(resumed, batches[3], gen(3))
    assert resumed.updates == state.updates == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a['state'].keys() == b['state'].keys()
    for i in a['state']:
        for k in a['state'][i]:
            assert torch.equal(a['state'][i][k], b['state'][i][k]), (i, k)


def test_pruning_and_interrupted_writes(tmp_path, tconf):
    state = _state(tconf)
    manager = tckpt.CheckpointManager(str(tmp_path), keep_n=2)
    ckdir = os.path.join(str(tmp_path), 'checkpoints')
    for step in (1, 2, 3):
        manager.save_at_step(step, state)
    assert sorted(os.listdir(ckdir)) == ['0000002.ckpt', '0000003.ckpt']
    # A write cut short leaves a .tmp directory: never loaded, and a
    # later save at that step replaces it.
    os.makedirs(os.path.join(ckdir, '0000009.ckpt.tmp'))
    with open(os.path.join(ckdir, '0000009.ckpt.tmp', 'eye_net.npz'),
              'w') as f:
        f.write('truncated')
    assert manager.load_last_checkpoint(_state(tconf, seed=3)) == 3
    manager.save_at_step(9, state)
    assert sorted(os.listdir(ckdir)) == ['0000003.ckpt', '0000009.ckpt']
    # A RefineNet checkpoint does not fit a model without one.
    eye_only = teve.init_model(teve.EveSpec(), torch.Generator(), 'cpu')
    with pytest.raises(KeyError, match='does not have'):
        manager.load_last_checkpoint(tstep.TrainState(eye_only, None, None),
                                     load_optimizer=False)


def test_flatten_tree_round_trip():
    tree = {'a': {'b': np.arange(3, dtype=np.float32),
                  'c': {'d': np.ones((2, 2), np.float32)}}}
    flat = tckpt.flatten_tree(tree)
    assert sorted(flat) == ['a/b', 'a/c/d']
    assert _flat(tckpt.unflatten_tree(flat)).keys() == _flat(tree).keys()


@pytest.mark.parametrize('spec', [
    dict(),
    dict(eye_net_use_rnn=False),
    dict(eye_net_rnn_type='LSTM'),
    dict(refine_net_enabled=True, refine_net_rnn_type='CGRU'),
    dict(refine_net_enabled=True, load_screen_content=True,
         refine_net_rnn_type='CLSTM', refine_net_use_skip_connections=False),
], ids=['gru', 'static', 'lstm', 'cgru', 'clstm_noskip'])
def test_eve_params_inverts_eve_state_dict(spec):
    """eve_tpu tree -> port state dict -> eve_tpu tree is the identity,
    bitwise, for each cell type and topology switch."""
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        jeve.init_params, jeve.EveSpec(**spec)))(jax.random.PRNGKey(2)))
    back = convert.eve_params(convert.eve_state_dict(tree))
    got, want = _flat(back), _flat(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
