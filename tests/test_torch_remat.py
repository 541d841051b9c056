"""``tpu_remat`` in the port against eve_tpu, on the CPU.

eve_tpu's ``tpu_remat`` wraps EyeNet's ResNet features ('eye'), RefineNet's
encoder ('refine') or both ('all') in ``jax.checkpoint``; the port wraps
the same stages in ``torch.utils.checkpoint``. Recomputing a stage in the
backward pass runs the same operations on the same inputs, so a train
step's gradients must equal the port's without remat bitwise, and eve_tpu's
with the same ``remat`` at the train-step parity tolerances
(``tests/test_torch_train_step.py``: RefineNet 0.1 of a tensor's largest
element and 3e-2 L2, EyeNet 2e-3 and 1e-3). A forward that records a graph
with remat must keep fewer tensors for the backward pass (counted with
``saved_tensors_hooks``), so remat really applies; 'eye' under a frozen
EyeNet and inference keep as many as without it.

Cases: 'eye' on ``configs/eye_net.json`` (48x48 eyes), 'refine' on
``configs/refine_net.json`` (frozen EyeNet, 32x32), 'all' on
``configs/refine_net.json`` with EyeNet trainable (32x32: at 48x48 this
model's ``loss_ce_heatmap_final`` meets saturated pixels, where the two
packages' losses differ by 3e-4 with or without remat); B = 2, T = 3,
eve_tpu's perturbed ``init_params`` weights, injected kappas.
"""

import os

import numpy as np
import pytest

import jax
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.models import eve as jeve
from eve_tpu.train import harness as jharness
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.cli import common
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert
from tests.test_torch_train_step import (CASES, GRAD_GLOBAL_ATOL, TOLERANCES,
                                         _configs, grad_tolerance,
                                         initial_params, make_batch)

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')
REMAT_CASES = {
    'eye': ('eye_net', {}),
    'refine': ('refine_net', {}),
    'all': ('refine_net', {'eye_net_frozen': False}),
}


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('value,want', [
    (True, 'all'), (False, 'none'), ('refine', 'refine'), ('EYE', 'eye'),
    ('yes', 'all'), ('0', 'none'), ('none', 'none')])
def test_remat_value_normalization(value, want):
    """eve_tpu's ``test_remat_value_normalization``: its booleans and
    their spellings, and the mode names, on both packages."""
    cfg = tconfig.Config()
    cfg.import_dict({'tpu_remat': value})
    assert cfg.tpu_remat == want
    DefaultConfig._reset_instance_for_testing()
    try:
        ref = DefaultConfig()
        ref.import_dict({'tpu_remat': value})
        assert ref.tpu_remat == want
    finally:
        DefaultConfig._reset_instance_for_testing()


def test_remat_typos_raise_and_the_cli_takes_booleans():
    with pytest.raises(ValueError, match='tpu_remat'):
        tconfig.Config().import_dict({'tpu_remat': 'eyes'})
    with pytest.raises(ValueError, match='tpu_remat'):
        tconfig.Config().import_dict({'tpu_remat': 2})
    config, _ = common.parse_config(['--tpu-remat', 'True'])
    assert config.tpu_remat == 'all'
    DefaultConfig._reset_instance_for_testing()
    try:
        assert jharness.script_init_common(
            argv=['--tpu-remat', 'True']).tpu_remat == 'all'
    finally:
        DefaultConfig._reset_instance_for_testing()
    spec = teve.EveSpec.from_config(config)
    assert spec.remat_eye and spec.remat_refine
    # The seq and model mesh axes are real keys with eve_tpu's defaults;
    # no key of eve_tpu's raises unless at its default any longer.
    assert (tconfig.Config().tpu_sequence_shards,
            tconfig.Config().tpu_model_parallelism) == (1, 1)
    assert not hasattr(tconfig, 'UNIMPLEMENTED_KEYS')


def _case(name):
    base, extra = REMAT_CASES[name]
    json_name, eyes, overrides = CASES[base]
    return base, json_name, eyes, dict(overrides, **extra)


def _port_config(json_name, overrides):
    tc = tconfig.Config()
    tc.import_json(os.path.join(CONFIGS, json_name))
    tc.import_dict(overrides)
    return tc


def _port_grads(tc, params, batch):
    """``(full_loss, {name: gradient}, tensors saved for backward)``."""
    model = teve.build_model(teve.EveSpec.from_config(tc),
                             convert.eve_state_dict(params), 'cpu')
    tstep.create_train_state(tc, model, 4)  # the train mode and optimizer
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = tstep.accumulate_gradients(model,
                                         teve.batch_to_tensors(batch, 'cpu'))
    return (out['full_loss'].item(),
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}, sum(saved))


@pytest.mark.parametrize('name', sorted(REMAT_CASES))
def test_train_step_gradients_with_remat(name):
    base, json_name, eyes, overrides = _case(name)
    jspec, _, _, tc = _configs(json_name, dict(overrides, tpu_remat=name))
    assert (jspec.remat_eye, jspec.remat_refine) == (
        name in ('eye', 'all'), name in ('refine', 'all'))
    params = initial_params(jspec)
    batch = make_batch(1, eyes)
    loss, grads, saved = _port_grads(tc, params, batch)
    loss_off, grads_off, saved_off = _port_grads(
        _port_config(json_name, overrides), params, batch)
    # Recomputation repeats the same operations: bitwise the same step.
    assert loss == loss_off
    assert grads.keys() == grads_off.keys() and grads
    for k, g in grads.items():
        assert torch.equal(g, grads_off[k]), k
    assert saved < saved_off, (saved, saved_off)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jeve.forward(jspec, p, batch, training=True)['full_loss']
    ))(params)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    want = {k: v.numpy() for k, v in convert.eve_state_dict(
        jax.tree_util.tree_map(np.asarray, ref_grads)).items()
        if k in grads}
    top = max(float(np.abs(g).max()) for g in want.values())
    elem, l2, _ = TOLERANCES['refine_net' if name == 'all' else base]
    tol = grad_tolerance(want, top, elem)
    for k, w in want.items():
        got = grads[k].numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=tol[k], err_msg=k)
        assert np.linalg.norm(got - w) <= (
            l2 * np.linalg.norm(w) +
            GRAD_GLOBAL_ATOL * top * np.sqrt(got.size)), k


def test_remat_changes_nothing_without_a_graph():
    """'eye' under a frozen EyeNet (its stages keep no graph) and an
    inference forward keep the tensors they keep without remat."""
    _, json_name, eyes, overrides = _case('refine')
    tc = _port_config(json_name, overrides)
    model = teve.init_model(teve.EveSpec.from_config(tc),
                            torch.Generator().manual_seed(0), 'cpu')
    batch = teve.batch_to_tensors(make_batch(2, eyes), 'cpu')
    counts = {}
    for remat in ('none', 'eye', 'all'):
        tc.import_dict({'tpu_remat': remat})
        model.spec = teve.EveSpec.from_config(tc)
        for training in (True, False):
            saved = []
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.append(t.numel()) or t, lambda t: t):
                model(batch, training=training,
                      generator=torch.Generator().manual_seed(0))
            counts[remat, training] = sum(saved)
    assert counts['eye', True] == counts['none', True]
    assert counts['all', True] < counts['none', True]  # the encoder
    assert counts['none', False] == counts['eye', False] == \
        counts['all', False]
