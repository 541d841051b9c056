"""Batch echoing and several training sources in the port's harness.

- ``train_batch_echoing`` = N runs N loop steps per loaded batch, as
  eve_tpu's ``tests/test_harness.py`` checks its own; the epoch count, the
  LR schedule's updates and a resume's data position follow the echo.
- Two training sources: ``multi_source_train_step``'s loss and gradients
  against eve_tpu's ``make_multi_source_train_step`` on the same weights
  and batches with injected kappas (``configs/refine_net.json``, frozen
  EyeNet, 32x32 eyes, B = 2, T = 3), with the tolerances of
  ``tests/test_torch_train_step.py``: ``full_loss`` rtol 1e-5, RefineNet
  gradients within 0.1 of each tensor's largest element and 3e-2 of its L2
  norm, plus 1e-5 of the largest gradient. eve_tpu's step is given an
  optimizer that keeps the gradient as its state, so its gradients are
  read exactly.
- A harness run over two sources of different lengths: steps per epoch
  from the larger, each source's scalars prefixed with its tag, the sum as
  ``full_loss``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from eve_tpu.train import step as jstep
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import harness
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert
from tests.test_torch_train_step import (
    CASES, GRAD_GLOBAL_ATOL, TOLERANCES, _configs, initial_params, make_batch)
from tests.torch_clips import specs

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


def _config(**overrides):
    cfg = tconfig.Config()
    cfg.import_json(CONFIG)
    cfg.import_dict(dict({
        'eye_net_load_pretrained': False, 'batch_size': 2, 'num_epochs': 1.0,
        'max_sequence_len': 3, 'eyes_size': [32, 32],
        'fully_reproducible': True, 'train_data_workers': 0,
        'checkpoints_save_every_n_steps': 1000, 'test_every_n_steps': 1000,
        'test_num_samples': 2, 'test_batch_size': 2}, **overrides))
    return cfg


class CountingLoader:
    """A training loader that counts the batches it yields."""

    def __init__(self, inner):
        self.inner = inner
        self.batch_size = inner.batch_size
        self.count = 0

    def __len__(self):
        return len(self.inner)

    def fast_forward(self, num_batches):
        self.inner.fast_forward(num_batches)

    def __iter__(self):
        for batch in self.inner:
            self.count += 1
            yield batch


def _run(cfg, base, train_specs, counting=False):
    train, test = harness.init_datasets(cfg, train_specs,
                                        [specs('val', 9, 2)])
    if counting:
        for data in train.values():
            data['dataloader'] = CountingLoader(data['dataloader'])
    exp = harness.Experiment(cfg, str(base), device='cpu')
    try:
        steps = {s: m for s, m, _ in harness.main_loop_iterator(exp, train,
                                                                test)}
    finally:
        exp.close()
    return exp, train, steps


@pytest.mark.parametrize('echo', [1, 2])
def test_echoing_steps_per_loaded_batch(tmp_path, echo):
    exp, train, steps = _run(_config(train_batch_echoing=echo), tmp_path,
                             [specs('train', 0, 8)], counting=True)
    loads = train['train']['dataloader'].count
    assert loads == 4  # one epoch of 8 clips in batches of 2
    assert sorted(steps) == list(range(echo * loads))
    assert exp.state.step == echo * loads
    # The schedule counts updates: echo x batches of them an epoch.
    assert exp.state.updates == echo * loads
    assert exp.last_epoch == (len(steps) - 1) // echo * 2 / 8


def test_multi_source_step_matches_eve_tpu():
    json_name, eyes, overrides = CASES['refine_net']
    jspec, _, _, tc = _configs(json_name, overrides)
    params = initial_params(jspec)
    batches = {'a': make_batch(1, eyes), 'b': make_batch(2, eyes)}

    # An optimizer whose state is the gradient it was given.
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jstep.make_multi_source_train_step(jspec, keep, tags=['a', 'b'],
                                              donate=False)
    state = jstep.TrainState(step=np.int32(0), params=params,
                             opt_state=keep.init(params))
    new_state, metrics = step(state, batches, jax.random.PRNGKey(0))
    want_grads = {k: v.numpy() for k, v in convert.eve_state_dict(
        jax.tree_util.tree_map(np.asarray, new_state.opt_state)).items()}

    model = teve.build_model(teve.EveSpec.from_config(tc),
                             convert.eve_state_dict(params), 'cpu')
    out = tstep.accumulate_multi_source_gradients(
        model, {t: teve.batch_to_tensors(b, 'cpu')
                for t, b in batches.items()})
    for key in ('a/full_loss', 'b/full_loss', 'full_loss',
                'a/metric_euc_PoG_px_final'):
        np.testing.assert_allclose(out[key].item(), float(metrics[key]),
                                   rtol=1e-5, err_msg=key)
    assert set(metrics) - {'nan_flag'} == set(out)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert named and all(n.startswith('refine_net.') for n in named)
    top = max(float(np.abs(want_grads[n]).max()) for n in named)
    elem, l2, _ = TOLERANCES['refine_net']
    for n, p in named.items():
        got = (np.zeros_like(want_grads[n]) if p.grad is None
               else p.grad.numpy())
        want = want_grads[n]
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=elem * np.abs(want).max() + GRAD_GLOBAL_ATOL * top,
            err_msg=n)
        assert np.linalg.norm(got - want) <= (
            l2 * np.linalg.norm(want) +
            GRAD_GLOBAL_ATOL * top * np.sqrt(got.size)), n


def test_two_sources_of_different_lengths(tmp_path):
    exp, train, steps = _run(_config(), tmp_path,
                             [specs('long', 0, 8), specs('short', 3, 4)],
                             counting=True)
    # Steps per epoch from the larger source; the smaller one wraps.
    assert sorted(steps) == [0, 1, 2, 3]
    assert train['long']['dataloader'].count == 4
    assert train['short']['dataloader'].count == 4
    for metrics in steps.values():
        assert {'long/full_loss', 'short/full_loss', 'full_loss',
                'nan_flag'} <= set(metrics)
        assert not any(k.startswith('loss_') for k in metrics)
        torch.testing.assert_close(
            metrics['full_loss'],
            metrics['long/full_loss'] + metrics['short/full_loss'])
        assert not bool(metrics['nan_flag'])
    assert exp.state.step == 4
    # Each source draws its own kappas.
    a = harness.kappa_generator(0, 3, 0).initial_seed()
    b = harness.kappa_generator(0, 3, 1).initial_seed()
    assert a != b != harness.kappa_generator(0, 3).initial_seed()
