"""The port's initialisers against eve_tpu's, on the CPU.

``init_weights`` draws every parameter as eve_tpu's initialisers do, from
a CPU generator. The two packages' random streams differ, so the draws are
held to eve_tpu's by their statistics, tensor by tensor (the full-width
``configs/refine_net.json`` model and a dense-LSTM EyeNet):

- a tensor eve_tpu initialises to a constant (zero heads, zero conv
  biases, instance-norm ones and zeros) is that constant, bitwise;
- a tensor of 4096 or more elements has the standard deviation of
  eve_tpu's within 5% (about 5 standard errors of the estimate) and a
  mean within 5% of it;
- uniform tensors stay within eve_tpu's bound and reach 90% of it, and a
  kaiming-normal convolution has eve_tpu's standard deviation within 2%.

The same seed gives the same weights on every device; another seed others.
"""

import functools
import os

import numpy as np
import pytest

import jax
import torch

from eve_tpu.models import eve as jeve
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
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



def _specs(**overrides):
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict(dict({'eye_net_load_pretrained': False}, **overrides))
    tspec = teve.EveSpec.from_config(tc)
    jspec = jeve.EveSpec(
        eye_net_rnn_type=tspec.eye_net_rnn_type, refine_net_enabled=True,
        load_screen_content=True, refine_net_rnn_type=tspec.refine_net_rnn_type)
    return tspec, jspec


@pytest.mark.parametrize('overrides', [
    {}, {'eye_net_rnn_type': 'LSTM', 'refine_net_rnn_type': 'CGRU'}],
    ids=['refine_net.json', 'lstm-cgru'])
def test_initialiser_statistics_match_eve_tpu(overrides):
    tspec, jspec = _specs(**overrides)
    ours = teve.init_model(tspec, torch.Generator().manual_seed(0),
                           'cpu').state_dict()
    ref = convert.eve_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.jit(functools.partial(jeve.init_params, jspec))(
            jax.random.PRNGKey(0))))
    assert ours.keys() == ref.keys()
    constants = 0
    for k, want in ref.items():
        got, want = ours[k].numpy(), want.numpy()
        if not want.any() or (want.size > 1 and np.all(want == want.flat[0])):
            np.testing.assert_array_equal(got, want, err_msg=k)
            constants += 1
            continue
        if want.size >= 4096:
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.05,
                                       err_msg=k)
            np.testing.assert_allclose(got.mean(), 0.0,
                                       atol=0.05 * want.std(), err_msg=k)
    assert ours['eye_net.fc_to_gaze.2.weight'].abs().max() == 0
    assert ours['refine_net.final.2.weight'].abs().max() == 0
    assert ours['refine_net.initial.0.bias'].abs().max() == 0
    assert ours['refine_net.initial.1.weight'].eq(1).all()
    assert constants > 50


def test_uniform_bounds_are_eve_tpus():
    """Linear layers and dense cells: U(+-1/sqrt(fan_in)), U(+-1/sqrt(H))."""
    tspec, _ = _specs()
    sd = teve.init_model(tspec, torch.Generator().manual_seed(1),
                         'cpu').state_dict()
    for k, bound in (('eye_net.fc_common.0.weight', 1 / np.sqrt(130)),
                     ('eye_net.fc_common.0.bias', 1 / np.sqrt(130)),
                     ('eye_net.cnn_layers.fc.weight', 1 / np.sqrt(512)),
                     ('eye_net.rnn_cells.0.weight_hh', 1 / np.sqrt(128)),
                     ('eye_net.rnn_cells.0.bias_ih', 1 / np.sqrt(128))):
        v = sd[k].abs()
        assert v.max() <= bound and v.max() > 0.9 * bound, k
    conv = sd['eye_net.cnn_layers.layer3.0.conv1.weight']
    np.testing.assert_allclose(float(conv.std()),
                               np.sqrt(2.0 / (256 * 9)), rtol=0.02)


def test_same_seed_same_weights_other_seed_others():
    tspec, _ = _specs()
    a, b, c = (teve.init_model(tspec, torch.Generator().manual_seed(s),
                               'cpu').state_dict() for s in (4, 4, 5))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['refine_net.initial.0.weight'],
                           c['refine_net.initial.0.weight'])
