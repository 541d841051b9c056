"""The port's networks against eve_tpu's flax modules, on the CPU.

Each flax module is initialised by eve_tpu, every parameter is perturbed
away from its initialisation (the zero-initialised gaze and heatmap heads
included, or their outputs would be constants and parity would prove
nothing), and the tree is carried into the port's module with
``eve_tpu_torch.utils.convert``. The same numpy inputs then go through both.

Eye patches are 48x48: at 32x32 ResNet-18's layer4 runs at 1x1, where
instance norm zeroes every activation and the output is the fc bias alone.

Tolerance: both sides run float32 convolutions whose sums are taken in a
different order (XLA vs. oneDNN): each layer adds ~1e-7 of the activation
scale, and through RefineNet's ~25 layers that reaches ~1e-5 of it. So each
stage is held to rtol 1e-4 plus 1e-4 of its largest magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu.models import eye_net as jeye
from eve_tpu.models import refine_net as jrefine
from eve_tpu.models import resnet as jresnet
from eve_tpu.utils import torch_convert
from eve_tpu_torch.models import eye_net as teye
from eve_tpu_torch.models import refine_net as trefine
from eve_tpu_torch.models import resnet as tresnet
from eve_tpu_torch.utils import convert

EYE = 48


def _perturb(tree, rng, scale=0.05):
    """Add N(0, scale) to every leaf (numpy float32 copy)."""
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _to_nchw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_resnet_matches_eve_tpu():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (3, EYE, EYE, 3)).astype(np.float32)
    net = jresnet.ResNet18IN(num_classes=16)
    params = _perturb(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x))['params'],
                      rng)
    ref = net.apply({'params': params}, jnp.asarray(x))
    sd = {k[len('cnn_layers.'):]: v
          for k, v in convert.eye_net_state_dict({'cnn': params}).items()}
    ours = _load(tresnet.ResNet18IN(num_classes=16), sd)(_nchw(x))
    _close(ours, ref)


@pytest.fixture(scope='module', params=['GRU', 'LSTM', 'RNN'])
def eye_nets(request):
    rng = np.random.RandomState(1)
    net = jeye.EyeNet(num_features=16, rnn_type=request.param)
    x = rng.uniform(-1, 1, (4, EYE, EYE, 3)).astype(np.float32)
    h = rng.uniform(-0.3, 0.3, (4, 2)).astype(np.float32)
    params = _perturb(jax.jit(net.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(h))['params'], rng)
    assert 'fc_to_gaze_2' in params  # zero-initialised, now perturbed
    ours = _load(teye.EyeNet(num_features=16, rnn_type=request.param),
                 convert.eye_net_state_dict(params))
    return net, params, ours, x, h


def test_eye_net_matches_eve_tpu(eye_nets):
    net, params, ours, x, h = eye_nets
    v = {'params': params}
    feats = net.apply(v, jnp.asarray(x), jnp.asarray(h),
                      method=jeye.EyeNet.features)
    t_feats = ours.features(_nchw(x), torch.from_numpy(h))
    _close(t_feats, feats)
    states = net.init_state(4)
    t_states = ours.init_state(4)
    for _ in range(3):  # a few steps so the carried state matters
        out, states = net.apply(v, feats, states,
                                method=jeye.EyeNet.recurrent)
        t_out, t_states = ours.recurrent(t_feats, t_states)
        _close(t_out, out)
    gaze, pupil = net.apply(v, out, method=jeye.EyeNet.heads)
    t_gaze, t_pupil = ours.heads(t_out)
    assert float(np.abs(np.asarray(gaze)).max()) > 1e-3
    _close(t_gaze, gaze)
    _close(t_pupil, pupil)


def test_eye_net_state_dict_keys_match_reference(eye_nets):
    _, params, ours, _, _ = eye_nets
    assert set(ours.state_dict()) == set(
        torch_convert.eye_net_params_to_torch(params))


@pytest.fixture(scope='module', params=[
    ('CGRU', True), ('CLSTM', True), ('CLSTM', False), ('CRNN', True)],
    ids=['CGRU', 'CLSTM', 'CLSTM-output', 'CRNN'])
def refine_nets(request):
    rnn_type, carry_only = request.param
    rng = np.random.RandomState(2)
    kw = dict(load_screen_content=True, rnn_type=rnn_type, num_features=8,
              clstm_carry_only=carry_only)
    net = jrefine.RefineNet(**kw)
    hm = rng.uniform(0, 1, (2, 72, 128)).astype(np.float32)
    screen = rng.uniform(0, 1, (2, 72, 128, 3)).astype(np.float32)
    params = _perturb(jax.jit(net.init)(jax.random.PRNGKey(2), jnp.asarray(hm),
                               jnp.asarray(screen))['params'], rng)
    # The 1x1 head starts at zero; a larger kick makes the heatmap vary.
    params['final_2']['kernel'] *= 20.0
    ours = _load(trefine.RefineNet(**kw), convert.refine_net_state_dict(params))
    return net, params, ours, hm, screen


def test_refine_net_matches_eve_tpu(refine_nets):
    """Stage by stage, each stage fed eve_tpu's own input to it."""
    net, params, ours, hm, screen = refine_nets
    v = {'params': params}
    x = net.apply(v, jnp.asarray(hm), jnp.asarray(screen),
                  method='assemble_input')
    t_x = ours.assemble_input(torch.from_numpy(hm), _nchw(screen))
    _close(t_x, _to_nchw(x))
    bott, skips = net.apply(v, x, method='encode')
    t_bott, t_skips = ours.encode(_nchw(np.asarray(x)))
    _close(t_bott, _to_nchw(bott))
    for t_skip, skip in zip(t_skips, skips):
        _close(t_skip, _to_nchw(skip))
    states = net.init_state(2)
    t_states = ours.init_state(2)
    for _ in range(3):
        out, new_states = net.apply(v, bott, states,
                                    method='bottleneck_step')
        t_out, t_new = ours.bottleneck_step(
            _nchw(np.asarray(bott)),
            jax.tree.map(lambda a: _nchw(np.asarray(a)), states))
        _close(t_out, _to_nchw(out))
        jax.tree.map(lambda a, b: _close(a, _to_nchw(b)), t_new, new_states)
        states = new_states
    final = net.apply(v, out, skips, method='decode')
    t_final = ours.decode(_nchw(np.asarray(out)),
                          [_nchw(np.asarray(s)) for s in skips])
    assert float(np.asarray(final).std()) > 1e-3  # not a constant 0.5
    _close(t_final, final)


def test_refine_net_state_dict_keys_match_reference(refine_nets):
    _, params, ours, _, _ = refine_nets
    assert set(ours.state_dict()) == set(
        torch_convert.refine_net_params_to_torch(params))
