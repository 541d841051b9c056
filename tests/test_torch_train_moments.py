"""Resuming an eve_tpu run carries its optax moments into torch Adam.

For each optax chain layout eve_tpu builds (``eve_tpu/train/optim.py``):
the flat chain (``configs/eye_net.json``), ``multi_transform`` with a
frozen EyeNet (``configs/refine_net.json``), per-submodule LR multipliers,
and ``MultiSteps`` under ``gradient_accumulation_steps`` 2 (with and
without the frozen EyeNet, and stopped mid-accumulation, so its running
mean of the gradients is carried over): eve_tpu takes 3 micro-steps on the
model's parameter tree and saves a checkpoint with its own
``CheckpointManager``; the port loads it into a fresh ``TrainState`` and
takes 3 more; eve_tpu takes the same 3. Both see the same fixed gradients
(no forward, so no chaos), and the parameters agree within the trajectory
tolerance of ``tests/test_torch_train_optim.py`` at update 6: rtol 2e-5 +
1e-5 per update, atol 3e-7 per update. A port that started a fresh Adam
instead misses it by far (checked). A leaf that the map cannot place
raises, naming it.
"""

import logging
import os

import numpy as np
import pytest

import jax
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.train import optim as joptim
from eve_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from eve_tpu.train.checkpoint import flatten_tree as jflatten
from eve_tpu.train.step import TrainState as JaxTrainState
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')
UPDATES_PER_EPOCH = 3
BEFORE, AFTER = 3, 3   # micro-steps before and after the checkpoint
# No weight decay: with millions of elements, a few have a gradient that
# the decay term nearly cancels, and the two frameworks' last-bit
# differences then send Adam's step either way (the decayed chain is held
# by tests/test_torch_train_optim.py on toy parameters).
BASE = {'batch_size': 2, 'base_learning_rate': 0.01, 'weight_decay': 0.0,
        'do_gradient_clipping': True, 'gradient_clip_amount': 1.0,
        'num_warmup_epochs': 1.0, 'lr_decay_strategy': 'exponential',
        'lr_decay_epoch_interval': 1.0, 'eye_net_load_pretrained': False}
LAYOUTS = {
    'flat': ('eye_net.json', {}),
    'frozen-eye': ('refine_net.json', {}),
    'per-submodule-lr': ('refine_net.json', {
        'eye_net_frozen': False, 'eye_net_learning_rate_multiplier': 0.5,
        'refine_net_learning_rate_multiplier': 2.0}),
    'multisteps': ('eye_net.json', {'gradient_accumulation_steps': 2}),
    'multisteps-frozen-eye': ('refine_net.json', {
        'gradient_accumulation_steps': 2}),
}


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _configs(json_name, overrides):
    path = os.path.join(CONFIGS, json_name)
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(path)
        jc.import_dict(overrides)
        tx, _ = joptim.build_optimizer(jc, UPDATES_PER_EPOCH)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(path)
    tc.import_dict(overrides)
    return tx, tc


def _grads(tree, step):
    """Fixed gradients of micro-step ``step``; every third one is large,
    so norm clipping acts on some updates and not on others. They are
    multiples of 2^-20, so that optax's running mean of two micro-steps
    and the port's sum of them, halved, are both exact: an element whose
    gradient rounded to 0 in one and not in the other would take Adam's
    step in either direction."""
    rs = np.random.RandomState(100 + step)
    scale = 0.05 if step % 3 == 0 else 1e-4
    return jax.tree_util.tree_map(
        lambda v: (np.round(scale * rs.normal(size=np.shape(v)) * 2 ** 20)
                   / 2 ** 20).astype(np.float32), tree)


def _eve_tpu_steps(tx, params, opt_state, grads):
    """eve_tpu's micro-steps (its train step's ``tx.update`` and add) over
    the gradient trees ``grads``."""
    @jax.jit
    def apply(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return (jax.tree_util.tree_map(lambda p, u: p + u, params, updates),
                opt_state)

    for g in grads:
        params, opt_state = apply(params, opt_state, g)
    return jax.tree_util.tree_map(np.asarray, params), opt_state


def _port_steps(state, grads):
    """The same micro-steps through the port's update: the gradients (port
    state dicts) add up in ``.grad`` and every ``accumulation_steps``-th
    one updates."""
    trainable = {n: p for n, p in state.model.named_parameters()
                 if p.requires_grad}
    for g in grads:
        for n, p in trainable.items():
            p.grad = g[n].clone() if p.grad is None else p.grad + g[n]
        state.step += 1
        if state.step % state.accumulation_steps == 0:
            tstep.apply_update(state)


def _port_state(tc, tree):
    spec = teve.EveSpec.from_config(tc)
    model = teve.build_model(spec, convert.eve_state_dict(tree), 'cpu')
    return tstep.create_train_state(tc, model, UPDATES_PER_EPOCH)


@pytest.fixture(scope='module')
def initial_tree():
    """The parameter tree of a port model with every submodule (seeded)."""
    tc = tconfig.Config()
    tc.import_json(os.path.join(CONFIGS, 'refine_net.json'))
    model = teve.init_model(teve.EveSpec.from_config(tc),
                            torch.Generator().manual_seed(4), 'cpu')
    return convert.eve_params(model.state_dict())


@pytest.fixture(scope='module')
def gradients(initial_tree):
    """Each micro-step's gradients: eve_tpu trees and port state dicts."""
    trees = [_grads(initial_tree, step) for step in range(BEFORE + AFTER)]
    return trees, [convert.eve_state_dict(t) for t in trees]


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_resume_carries_eve_tpus_moments(layout, initial_tree, gradients,
                                         tmp_path, caplog):
    json_name, extra = LAYOUTS[layout]
    tx, tc = _configs(json_name, dict(BASE, **extra))
    subs = ['eye_net'] + (['refine_net'] if tc.refine_net_enabled else [])
    tree = {k: initial_tree[k] for k in subs}
    trees = [{k: t[k] for k in subs} for t in gradients[0]]
    params, opt_state = _eve_tpu_steps(tx, tree, tx.init(tree),
                                       trees[:BEFORE])
    run = str(tmp_path / 'run')
    JaxCheckpoints(run).save_at_step(BEFORE, JaxTrainState(
        step=np.int32(BEFORE), params=params, opt_state=opt_state))
    want, _ = _eve_tpu_steps(tx, params, opt_state, trees[BEFORE:])
    want = {k: v.numpy() for k, v in convert.eve_state_dict(want).items()}

    def resumed(load_optimizer):
        state = _port_state(tc, tree)
        with caplog.at_level(logging.INFO):
            step = tckpt.CheckpointManager(run).load_last_checkpoint(
                state, load_optimizer=load_optimizer)
        assert step == state.step == BEFORE
        _port_steps(state, gradients[1][BEFORE:])
        return {k: v.numpy() for k, v in state.model.state_dict().items()}

    got = resumed(True)
    assert 'optimizer_0.npz' in caplog.text
    assert 'fresh optimizer' not in caplog.text
    update = BEFORE + AFTER
    tol = dict(rtol=2e-5 + 1e-5 * update, atol=3e-7 * (1 + update))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
    if layout == 'flat':
        # Without the moments the continuation leaves the tolerance.
        fresh = resumed(False)
        assert any(not np.allclose(fresh[k], v, **tol)
                   for k, v in want.items())


def test_unplaceable_leaves_raise(initial_tree, tmp_path):
    tx, tc = _configs('eye_net.json', BASE)
    tree = {'eye_net': initial_tree['eye_net']}
    flat = jflatten(tx.init(tree))
    state = _port_state(tc, tree)
    extra = dict(flat, **{'2/mu/eye_net/cnn/conv9/kernel':
                          np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError, match='conv9'):
        tckpt.optax_optimizer_tree(state, extra)
    stray = dict(flat, **{'2/mu/head/w': np.zeros(1, np.float32),
                          '2/nu/head/w': np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match='head'):
        tckpt.optax_optimizer_tree(state, stray)
    missing = {k: v for k, v in flat.items() if '/fc/' not in k}
    with pytest.raises(KeyError, match='no Adam moments'):
        tckpt.optax_optimizer_tree(state, missing)
    state.step = 1  # under accumulation 1, no update is ever partial
    with pytest.raises(ValueError, match='micro-steps into an update'):
        tckpt.optax_optimizer_tree(state, dict(flat, mini_step=np.int32(1)))
