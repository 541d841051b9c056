"""The whole serving slice: the port's EVE forward against eve_tpu's, on the CPU.

The ``configs/refine_net.json`` model (GRU EyeNet, CLSTM RefineNet with
screen content) is built by both packages from the same JSON. eve_tpu's
``init_params`` makes the weights; every parameter is perturbed (the
zero-initialised ``fc_to_gaze.2`` and ``final.2`` included, or gaze would be
0 and the refined heatmap a constant 0.5) and carried into the port with
``eve_tpu_torch.utils.convert``. One seeded batch with labels goes through
``forward(training=False, output_predictions=True)`` in both, and every
output key is compared.

Eye patches are 48x48, B=2, T=3 (at 32x32 ResNet-18's layer4 is 1x1 and
instance norm erases the pixels).

Tolerances, with their reasons:
- PoG in screen px: rtol 1e-4, atol 1e-2 px. The refined PoG is a beta=100
  soft-argmax read off RefineNet's output, which has passed ~25 float32
  convolutions summed in another order than XLA's (~1e-6 relative), and
  the soft-argmax scales heatmap differences by up to beta * 1920 px.
- Everything else (gazes, pupils, PoG in cm, losses, metrics): rtol 1e-4,
  atol 1e-4. Values of order 1 differ by float32 rounding; the relative
  term covers losses that are means of squared px errors (~1e5).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

import jax
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import eve as jeve
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.utils import convert

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
EYE = 48


def _tolerance(key):
    if 'PoG_px' in key:
        return dict(rtol=1e-4, atol=1e-2)
    return dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope='module')
def specs():
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    return jspec, teve.EveSpec.from_config(tc)


@pytest.fixture(scope='module')
def params(specs):
    jspec, _ = specs
    tree = jax.jit(functools.partial(jeve.init_params, jspec))(
        jax.random.PRNGKey(0))
    tree = _perturb(tree, np.random.RandomState(0))
    # The 1x1 heatmap head starts at zero; a larger kick makes the refined
    # heatmap vary across the screen.
    tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


@pytest.fixture(scope='module')
def model(specs, params):
    return teve.build_model(specs[1], convert.eve_state_dict(params), 'cpu')


def _batch(seed, frame_dtype=np.uint8, B=2, T=3):
    return make_synthetic_batch(np.random.RandomState(seed), batch_size=B,
                                sequence_len=T, eyes_size=EYE,
                                frame_dtype=frame_dtype)


def _jax_forward(jspec, params, batch):
    fn = jax.jit(lambda p, b: jeve.forward(jspec, p, b, training=False,
                                           output_predictions=True))
    return {k: np.asarray(v) for k, v in fn(params, batch).items()}


def _port_forward(model, batch, **kw):
    with torch.inference_mode():
        return model(teve.batch_to_tensors(batch, 'cpu'),
                     output_predictions=True, **kw)


@pytest.mark.parametrize('frame_dtype', [np.uint8, np.float32],
                         ids=['uint8', 'float32'])
def test_forward_matches_eve_tpu(specs, params, model, frame_dtype):
    batch = _batch(1, frame_dtype)
    ref = _jax_forward(specs[0], params, batch)
    ours = _port_forward(model, batch)
    assert set(ours) == set(ref)
    assert np.abs(ref['g_initial']).max() > 1e-3       # the gaze head is live
    assert np.ptp(ref['PoG_px_final']) > 1.0            # and the heatmap head
    for key in sorted(ref):
        np.testing.assert_allclose(
            ours[key].numpy().astype(ref[key].dtype), ref[key],
            err_msg=key, **_tolerance(key))


def test_labels_match_eve_tpu_with_invalid_frames(specs):
    """The masked ground-truth heatmaps (one multi-sigma render) and the
    other derived labels equal eve_tpu's, invalid frames included."""
    batch = _batch(3)
    batch['left_PoG_tobii_validity'][0, 1] = 0
    batch['right_PoG_tobii_validity'][1, 2] = 0
    ref = {k: np.asarray(v) for k, v in jeve.calculate_additional_labels(
        specs[0], batch, None, False).items()}
    ours = teve.calculate_additional_labels(
        specs[1], teve.batch_to_tensors(batch, 'cpu'))
    assert set(ref) <= set(ours)
    for key in sorted(ref):
        np.testing.assert_allclose(
            ours[key].numpy().astype(ref[key].dtype), ref[key], err_msg=key,
            rtol=1e-6 if key.startswith('heatmap') else 1e-4,
            atol=1e-7 if key.startswith('heatmap') else 1e-4)
    for name in ('heatmap_initial', 'heatmap_history', 'heatmap_final'):
        assert ours[name].shape == (2, 3, 72, 128)
        assert not ours[name][0, 1].any() and not ours[name][1, 2].any()
        assert ours[name][0, 0].min() > 0


def test_streaming_two_chunks_equals_one_clip(specs, model):
    batch = _batch(2, T=3)
    whole = _port_forward(model, batch)
    first = _port_forward(model, {k: v[:, :2] for k, v in batch.items()},
                          return_states=True)
    second = _port_forward(model, {k: v[:, 2:] for k, v in batch.items()},
                           initial_states=first['states'],
                           return_states=True)
    assert set(second['states']) == {'eye_left', 'eye_right', 'refine'}
    for key in ('PoG_px_initial', 'PoG_px_final', 'g_final',
                'left_pupil_size'):
        got = torch.cat([first[key], second[key]], dim=1).numpy()
        np.testing.assert_allclose(got, whole[key].numpy(), err_msg=key,
                                   **_tolerance(key))


def test_init_stream_state_shapes(specs, model):
    state = teve.init_stream_state(specs[1], 3)
    assert [s.shape for s in state['eye_left']] == [(3, 128)]
    # CLSTM carries (h, c), NCHW at the 5x8 bottleneck.
    ((h, c),) = state['refine']
    assert h.shape == c.shape == (3, 64, 5, 8)


def test_config_keys_cover_eve_tpu():
    """Every eve_tpu key is read by the port, deferred, or raises unless
    at its default: exactly one of the three."""
    port = set(tconfig.Config.keys())
    unimplemented = set(tconfig.UNIMPLEMENTED_KEYS)
    assert not port & tconfig.DEFERRED_KEYS
    assert not (port | tconfig.DEFERRED_KEYS) & unimplemented
    DefaultConfig._reset_instance_for_testing()
    try:
        assert port | tconfig.DEFERRED_KEYS | unimplemented == set(
            DefaultConfig().get_all_key_values())
    finally:
        DefaultConfig._reset_instance_for_testing()
    cfg = tconfig.Config()
    with pytest.raises(ValueError, match='Unknown'):
        cfg.import_dict({'refine_net_enabeld': True})
    with pytest.raises(TypeError, match='Type mismatch'):
        cfg.import_dict({'serve_port': '80'})
    cfg.import_dict({'gaze_heatmap_sigma_final': 4})  # int -> float
    assert cfg.gaze_heatmap_sigma_final == 4.0
    assert tconfig.Config().gaze_heatmap_sigma_final == 5.0  # no sharing


def test_later_slices_raise(specs, model):
    with pytest.raises(NotImplementedError, match='bfloat16'):
        teve.EVE(dataclasses.replace(specs[1], compute_dtype='bfloat16'))
    cfg = tconfig.Config()
    cfg.import_dict({'tpu_native_arch': True})
    with pytest.raises(NotImplementedError, match='tpu_native_arch'):
        teve.EveSpec.from_config(cfg)
