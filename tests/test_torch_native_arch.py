"""eve_tpu's opt-in topology (``tpu_native_arch``) in the port, on the CPU.

Both packages build ``configs/refine_net.json`` with ``tpu_native_arch``:
the patchify EyeNet stem ('patchify' 8x8/4 or 'patchify8' 8x8/8) and
RefineNetTPU with the 'heatmap' or 'gated' readout. The weights are
eve_tpu's ``init_params``, perturbed so that every head is live (the
zero-initialised ``final_2`` and ``gate_fc2`` included), carried into the
port through ``utils.convert``'s map of this topology.

Sizes: B = 2, T = 2 or 3; 64x64 eyes for 'patchify' and 72x72 for
'patchify8' (below 33 px and 65 px respectively ResNet-18's layer4 is 1x1,
where instance norm erases the pixels); the screen stays 72x128, which
RefineNetTPU asserts.

Tolerances are those of ``tests/test_torch_eve.py`` (PoG px rtol 1e-4 and
atol 1e-2 px, everything else rtol 1e-4 and atol 1e-4) and, for a train
step, of ``tests/test_torch_train_step.py``. At bfloat16, as in
``tests/test_torch_bf16.py``, each output's error against eve_tpu (compiled
without XLA's excess precision) is held below eve_tpu's own
bfloat16-vs-float32 drift on the same inputs: per-frame outputs below 1 of
it, 0-dim losses and metrics below 1.25, over four seeds.
"""

import functools
import logging
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import eve as jeve
from eve_tpu.models import layers as jlayers
from eve_tpu.train import checkpoint as jckpt
from eve_tpu.train import step as jstep
from eve_tpu.utils import load_model as jload
from eve_tpu_torch import config as tconfig
from eve_tpu_torch import infer
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.models import layers as tlayers
from eve_tpu_torch.models import refine_net_tpu as trefine_tpu
from eve_tpu_torch.models.resnet import ResNet18IN
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.train import harness
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert
from eve_tpu_torch.utils import load_model as tload

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')
CONFIG = os.path.join(CONFIGS, 'refine_net.json')
EYES = {'patchify': 64, 'patchify8': 72}
NO_EXCESS = {'xla_allow_excess_precision': False}
BF16_SEEDS = range(1, 9)
FRAME_RATIO, SCALAR_RATIO = 1.0, 1.25
# One train step: tests/test_torch_train_step.py's element and L2
# tolerances for a gradient that rounding can route otherwise (RefineNet's
# max-pool windows there). Both cases need them here: in the eye_net.json
# case a ReLU input of layer2.0 (its first norm's channel 3) lies 9.5e-8
# from 0 and XLA and oneDNN round it to either side, which moves that
# layer's gradient by 4.9e-3 of its largest element (1.0e-3 L2) and
# layer1's by 1.4e-3, while every other tensor agrees within 3e-4
# (measured); scaling the port's weights by (1 + 1e-7 N(0, 1)) moves no
# tensor by more than 5e-5.
GRAD_GLOBAL_ATOL = 1e-5
GRAD_ELEM, GRAD_L2 = 0.1, 3e-2


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tolerance(key):
    if 'PoG_px' in key:
        return dict(rtol=1e-4, atol=1e-2)
    return dict(rtol=1e-4, atol=1e-4)


def _overrides(stem='patchify', head='heatmap', dtype='float32', **kw):
    return dict({'tpu_native_arch': True, 'tpu_native_stem': stem,
                 'tpu_native_refine_head': head,
                 'tpu_compute_dtype': dtype,
                 'eye_net_load_pretrained': False}, **kw)


def _configs(json_name='refine_net.json', **overrides):
    """eve_tpu's and the port's config of ``json_name`` + overrides."""
    path = os.path.join(CONFIGS, json_name)
    DefaultConfig._reset_instance_for_testing()
    jc = DefaultConfig()
    jc.import_json(path)
    jc.import_dict(overrides)
    tc = tconfig.Config()
    tc.import_json(path)
    tc.import_dict(overrides)
    return jc, tc


def _specs(**kw):
    jc, tc = _configs(**_overrides(**kw))
    try:
        return jeve.EveSpec.from_config(jc), teve.EveSpec.from_config(tc)
    finally:
        DefaultConfig._reset_instance_for_testing()


def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _init_tree(seed=0):
    """eve_tpu's init_params of the gated topology (the 'heatmap' readout
    has the same tree without ``gate_*``; both stems have one tree)."""
    jspec, _ = _specs(head='gated')
    return jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        jeve.init_params, jspec))(jax.random.PRNGKey(seed)))


def _for_head(tree, head):
    if head == 'gated':
        return tree
    return dict(tree, refine_net={k: v for k, v in tree['refine_net'].items()
                                  if not k.startswith('gate_')})


@functools.lru_cache(maxsize=None)
def _live_tree():
    tree = _perturb(_init_tree(), np.random.RandomState(0))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    # A live pupil head: most of its ReLU's inputs positive.
    tree['eye_net']['fc_to_pupil_2']['bias'] += 1.0
    return tree


def params(head):
    return _for_head(_live_tree(), head)


def _batch(seed, stem, B=2, T=3, kappas=False):
    rng = np.random.RandomState(seed)
    batch = make_synthetic_batch(rng, batch_size=B, sequence_len=T,
                                 eyes_size=EYES[stem],
                                 frame_dtype=np.uint8)
    if kappas:
        for side in ('left', 'right'):
            kappa = np.radians(3.0) * rng.normal(size=(B, 2))
            batch[side + '_kappa_fake'] = np.repeat(
                kappa[:, None].astype(np.float32), T, axis=1)
    return batch


def _port_forward(model, batch, **kw):
    with torch.inference_mode():
        return model(teve.batch_to_tensors(batch, 'cpu'),
                     output_predictions=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_forward(stem, head, dtype):
    """eve_tpu's inference forward, compiled (at bfloat16 without excess
    precision)."""
    jspec, _ = _specs(stem=stem, head=head, dtype=dtype)
    fn = jax.jit(lambda p, b: jeve.forward(jspec, p, b, training=False,
                                           output_predictions=True))
    if dtype == 'bfloat16':
        fn = fn.lower(params(head), _batch(1, stem)).compile(
            compiler_options=NO_EXCESS)
    return lambda p, b: {k: np.asarray(v) for k, v in fn(p, b).items()}


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _max(a):
    return float(np.abs(a).max()) if np.size(a) else 0.0


# ----------------------------------------------------------------------
# Layers and modules
# ----------------------------------------------------------------------

@pytest.mark.parametrize('channels', [1, 3])
def test_depth_to_space_matches_eve_tpu(channels):
    """eve_tpu's (bh, bw, C) channel order, bitwise; F.pixel_shuffle's
    (C, bh, bw) agrees only at C = 1."""
    x = np.random.RandomState(0).normal(
        size=(2, 3, 5, 16 * channels)).astype(np.float32)
    ref = np.asarray(jlayers.depth_to_space(jnp.asarray(x), 4))
    ours = tlayers.depth_to_space(
        torch.from_numpy(np.moveaxis(x, -1, 1).copy()), 4)
    assert ours.shape == (2, channels, 12, 20)
    np.testing.assert_array_equal(np.moveaxis(ours.numpy(), 1, -1), ref)
    shuffled = F.pixel_shuffle(torch.from_numpy(
        np.moveaxis(x, -1, 1).copy()), 4)
    assert torch.equal(shuffled, ours) == (channels == 1)


def test_stems_and_their_small_input_warning(caplog):
    with pytest.raises(ValueError, match='Unknown ResNet18IN stem'):
        ResNet18IN(stem='patchify4')
    for stem, px, warns in (('patchify', 64, False), ('patchify8', 64, True),
                            ('patchify8', 72, False), ('patchify', 32, True)):
        net = ResNet18IN(num_classes=8, stem=stem)
        caplog.clear()
        with caplog.at_level(logging.WARNING), torch.no_grad():
            out = net(torch.zeros(1, 3, px, px))
        assert out.shape == (1, 8)
        assert ('below %dpx' % (65 if stem == 'patchify8' else 33)
                in caplog.text) == warns, (stem, px)
    conv = ResNet18IN(stem='patchify8').stem_conv
    assert (conv.kernel_size, conv.stride, conv.padding) == ((8, 8), (8, 8),
                                                             (0, 0))
    conv = ResNet18IN(stem='patchify').stem_conv
    assert (conv.kernel_size, conv.stride, conv.padding) == ((8, 8), (4, 4),
                                                             (2, 2))


def test_spec_and_modules_follow_eve_tpu():
    jspec, tspec = _specs(stem='patchify8', head='gated')
    assert (tspec.tpu_native_arch, tspec.tpu_native_stem,
            tspec.tpu_native_refine_head) == (True, 'patchify8', 'gated')
    model = teve.EVE(tspec)
    assert isinstance(model.refine_net, trefine_tpu.RefineNetTPU)
    assert model.eye_net.cnn_layers.stem == jspec.build_eye_net().stem
    assert model.refine_net.readout == jspec.build_refine_net().readout
    with pytest.raises(ValueError, match='72x128'):
        model.refine_net.encode(torch.zeros(1, 4, 36, 64))


def test_gated_readout_module_matches_eve_tpu():
    """RefineNetTPU's encoder, then ``decode_readout`` (heatmap, gate and
    delta) on the same encoding, against eve_tpu's module."""
    jspec, tspec = _specs(head='gated')
    tree = params('gated')['refine_net']
    jnet = jspec.build_refine_net()
    tnet = teve.build_model(tspec, convert.eve_state_dict(params('gated')),
                            'cpu').refine_net
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 1, (3, 72, 128, 4)).astype(np.float32)
    enc, skips = jnet.apply({'params': tree}, jnp.asarray(x),
                            method='encode')
    ref = jnet.apply({'params': tree}, enc, skips, method='decode_readout')
    with torch.no_grad():
        t_enc, t_skips = tnet.encode(torch.from_numpy(
            np.moveaxis(x, -1, 1).copy()))
        ours = tnet.decode_readout(t_enc, t_skips)
    np.testing.assert_allclose(t_enc.numpy(), np.moveaxis(np.asarray(enc),
                                                          -1, 1),
                               rtol=1e-4, atol=1e-4)
    for name, got, want in zip(('heatmap', 'gate', 'delta'), ours, ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **_tolerance(name))
    assert np.ptp(np.asarray(ref[1])) > 1e-3  # a live gate


# ----------------------------------------------------------------------
# The whole forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('head', ['heatmap', 'gated'])
@pytest.mark.parametrize('stem', ['patchify', 'patchify8'])
def test_forward_matches_eve_tpu(stem, head, dtype):
    _, tspec = _specs(stem=stem, head=head, dtype=dtype)
    model = teve.build_model(tspec, convert.eve_state_dict(params(head)),
                             'cpu')
    if dtype == 'float32':
        batch = _batch(1, stem)
        ref = _jax_forward(stem, head, dtype)(params(head), batch)
        ours = _port_forward(model, batch)
        assert set(ours) == set(ref)
        assert np.ptp(ref['PoG_px_final']) > 1.0    # the heatmap is live
        for key in sorted(ref):
            np.testing.assert_allclose(
                ours[key].numpy().astype(ref[key].dtype), ref[key],
                err_msg=key, **_tolerance(key))
        return
    errs, drifts, last = {}, {}, None
    for seed in BF16_SEEDS:
        batch = _batch(seed, stem)
        ref32 = _jax_forward(stem, head, 'float32')(params(head), batch)
        last = _jax_forward(stem, head, 'bfloat16')(params(head), batch)
        ours = _port_forward(model, batch)
        assert set(ours) == set(last)
        for k, want in last.items():
            got = ours[k].numpy()
            assert got.dtype == want.dtype, k
            if want.dtype == bool:
                np.testing.assert_array_equal(got, want, err_msg=k)
                continue
            errs.setdefault(k, []).append(_f32(got) - want)
            drifts.setdefault(k, []).append(want - _f32(ref32[k]))
    assert np.ptp(last['PoG_px_final']) > 1.0
    over = []
    for k in sorted(errs):
        err = max(_max(e) for e in errs[k])
        drift = max(_max(d) for d in drifts[k])
        if drift == 0.0:
            # Labels and geometry: float32 on both sides.
            np.testing.assert_allclose(
                np.concatenate([np.ravel(e) for e in errs[k]]), 0.0,
                atol=1e-4 * max(_max(last[k]), 1.0), err_msg=k)
            continue
        limit = FRAME_RATIO if np.ndim(last[k]) else SCALAR_RATIO
        print('%s %s %-36s error %.4g, drift %.4g, ratio %.3f (limit %g)'
              % (stem, head, k, err, drift, err / drift, limit))
        if not err < limit * drift:
            over.append((k, err, drift))
    assert not over, over


def test_gated_outputs_and_metrics():
    """The gated readout keeps the soft-argmax's reading: its metric
    equals the 'heatmap' readout's final-PoG metric on the same weights;
    the mean gate is a metric, and neither enters full_loss."""
    batch = _batch(5, 'patchify')
    outs = {}
    for head in ('heatmap', 'gated'):
        _, tspec = _specs(head=head)
        outs[head] = _port_forward(teve.build_model(
            tspec, convert.eve_state_dict(params(head)), 'cpu'), batch)
    gated, plain = outs['gated'], outs['heatmap']
    assert torch.equal(gated['metric_euc_PoG_px_heatmap_final'],
                       plain['metric_euc_PoG_px_final'])
    assert 0.0 < float(gated['metric_mean_refine_gate']) < 1.0
    assert 'metric_mean_refine_gate' not in plain
    assert not torch.equal(gated['PoG_px_final'], plain['PoG_px_final'])
    # full_loss reads PoG_px_final and the heatmap, not the diagnostics.
    for k in ('loss_ce_heatmap_final', 'loss_ce_heatmap_initial'):
        if k in plain:
            assert torch.equal(gated[k], plain[k]), k


def test_gated_readout_starts_at_the_initial_estimate():
    """Freshly initialised (zero ``gate_fc2``), the gate is sigmoid(-4) and
    delta 0: final = initial + sigmoid(-4) * (heatmap - initial)."""
    _, tspec = _specs(head='gated')
    model = teve.init_model(tspec, torch.Generator().manual_seed(0), 'cpu')
    with torch.no_grad():  # a live heatmap head
        model.refine_net.final_2.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    sd = {k: v for k, v in model.state_dict().items() if '.gate_fc' not in k}
    plain = teve.build_model(_specs()[1], sd, 'cpu')
    batch = _batch(6, 'patchify')
    out, ref = _port_forward(model.eval(), batch), _port_forward(plain, batch)
    sig = 1.0 / (1.0 + np.exp(4.0))
    np.testing.assert_allclose(float(out['metric_mean_refine_gate']), sig,
                               rtol=1e-6)
    initial = ref['PoG_px_initial'].numpy()
    np.testing.assert_allclose(
        out['PoG_px_final'].numpy(),
        initial + sig * (ref['PoG_px_final'].numpy() - initial),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize('head', ['heatmap', 'gated'])
def test_streaming_chunks_equal_one_clip(head):
    _, tspec = _specs(head=head)
    model = teve.build_model(tspec, convert.eve_state_dict(params(head)),
                             'cpu')
    batch = _batch(2, 'patchify', T=3)
    whole = _port_forward(model, batch)
    first = _port_forward(model, {k: v[:, :2] for k, v in batch.items()},
                          return_states=True)
    second = _port_forward(model, {k: v[:, 2:] for k, v in batch.items()},
                           initial_states=first['states'])
    ((h, c),) = first['states']['refine']
    assert h.shape == c.shape == (2, 64, 5, 8)
    for key in ('PoG_px_initial', 'PoG_px_final', 'g_final',
                'left_pupil_size'):
        got = torch.cat([first[key], second[key]], dim=1).numpy()
        np.testing.assert_allclose(got, whole[key].numpy(), err_msg=key,
                                   **_tolerance(key))


# ----------------------------------------------------------------------
# A training step
# ----------------------------------------------------------------------

STEP_CASES = {
    # A frozen EyeNet; the gated RefineNetTPU trains.
    'refine_net': ('refine_net.json', dict(head='gated', batch_size=2)),
    # configs/eye_net.json: the patchify stem's backward.
    'eye_net': ('eye_net.json', dict(batch_size=2)),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_train_step_loss_and_gradients_match_eve_tpu(case):
    json_name, kw = STEP_CASES[case]
    jc, tc = _configs(json_name, **_overrides(**kw))
    try:
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tree = params('gated')
    tree = {k: tree[k] for k in ('eye_net', 'refine_net')
            if k == 'eye_net' or jspec.refine_net_enabled}
    batch = _batch(1, 'patchify', T=3, kappas=True)

    def loss_fn(p):
        return jeve.forward(jspec, p, batch, training=True)['full_loss']

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    ref_grads = {k: v.numpy() for k, v in convert.eve_state_dict(
        jax.tree_util.tree_map(np.asarray, ref_grads)).items()}
    model = teve.build_model(teve.EveSpec.from_config(tc),
                             convert.eve_state_dict(tree), 'cpu')
    state = tstep.create_train_state(tc, model, 4)
    out = tstep.accumulate_gradients(state.model,
                                     teve.batch_to_tensors(batch, 'cpu'))
    np.testing.assert_allclose(out['full_loss'].item(), float(ref_loss),
                               rtol=1e-5)
    trained = {n: p for n, p in state.model.named_parameters()
               if p.requires_grad}
    assert trained and (case == 'eye_net') == all(
        n.startswith('eye_net.') for n in trained)
    top = max(float(np.abs(ref_grads[n]).max()) for n in trained)
    assert top > 0
    elem, l2 = GRAD_ELEM, GRAD_L2
    for n, p in trained.items():
        want = ref_grads[n]
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=elem * np.abs(want).max() + GRAD_GLOBAL_ATOL * top,
            err_msg=n)
        assert np.linalg.norm(got - want) <= (
            l2 * np.linalg.norm(want) +
            GRAD_GLOBAL_ATOL * top * np.sqrt(got.size)), n
    stem = 'eye_net.cnn_layers.stem_conv.weight'
    if case == 'eye_net':
        assert np.abs(trained[stem].grad.numpy()).max() > 0
    else:
        assert np.abs(trained['refine_net.gate_fc2.weight'].grad.numpy()
                      ).max() > 0


# ----------------------------------------------------------------------
# Weights, checkpoints, pretrained files, initialisers
# ----------------------------------------------------------------------

def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize('head', ['heatmap', 'gated'])
def test_weight_map_round_trips_bitwise(head):
    tree = params(head)
    sd = convert.eve_state_dict(tree)
    for key in ('eye_net.cnn_layers.stem_conv.weight', 'refine_net.stem.bias',
                'refine_net.enc_blocks.2.skip_layer.2.weight',
                'refine_net.dec_blocks.0.layers.3.weight',
                'refine_net.rnn_cells.0.gates.weight',
                'refine_net.final_0.weight', 'refine_net.final_2.bias'):
        assert key in sd, key
    assert ('refine_net.gate_fc1.weight' in sd) == (head == 'gated')
    model = teve.build_model(_specs(head=head)[1], sd, 'cpu')
    back = convert.eve_params(model.state_dict())
    got, want = _flat(back), _flat(tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = convert.eve_state_dict(back)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_eve_tpu_checkpoint_loads_through_model_setup(tmp_path):
    tree = params('gated')
    template = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                                params=tree, opt_state={})
    jckpt.CheckpointManager(str(tmp_path)).save_at_step(7, template)
    _, tc = _configs(**_overrides(head='gated', resume_from=str(tmp_path)))
    DefaultConfig._reset_instance_for_testing()
    model = infer.model_setup(tc, device='cpu')
    want = convert.eve_state_dict(tree)
    assert set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_port_checkpoint_loads_in_eve_tpu_bitwise(tmp_path):
    jc, tc = _configs(**_overrides(head='gated', batch_size=2))
    try:
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    model = teve.init_model(teve.EveSpec.from_config(tc),
                            torch.Generator().manual_seed(3), 'cpu')
    state = tstep.create_train_state(tc, model, 4)
    path = tckpt.CheckpointManager(str(tmp_path)).save_at_step(3, state)
    template = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), opt_state={},
        params=jax.jit(functools.partial(jeve.init_params, jspec))(
            jax.random.PRNGKey(1)))
    loaded, step = jckpt.CheckpointManager(str(tmp_path)).load(path,
                                                               template)
    assert step == 3
    got = _flat(loaded.params)
    want = _flat(convert.eve_params(model.state_dict()))
    assert set(got) == set(want) == set(_flat(template.params))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('stem', ['patchify', 'patchify8'])
def test_pretrained_file_names_are_eve_tpus(stem):
    jc, tc = _configs(**_overrides(stem=stem))
    try:
        for which in ('eye_net', 'refine_net'):
            assert tload.pretrained_filename(tc, which, '.npz') == \
                jload.pretrained_filename(jc, which, fmt='npz')
            assert tload.eligible_filenames(tc, which) == [
                jload.pretrained_filename(jc, which, fmt='npz')]
    finally:
        DefaultConfig._reset_instance_for_testing()
    assert tload.pretrained_filename(tc, 'eye_net', '.npz') == (
        'eve_eyenet_GRU_tpu8.npz' if stem == 'patchify8'
        else 'eve_eyenet_GRU_tpu.npz')
    assert tload.pretrained_filename(tc, 'refine_net', '.npz') == \
        'eve_refinenet_CLSTM_oa_skip_tpu.npz'


def _native_model(**kw):
    _, tc = _configs(**_overrides(**kw))
    DefaultConfig._reset_instance_for_testing()
    model = teve.init_model(teve.EveSpec.from_config(tc),
                            torch.Generator().manual_seed(0), 'cpu')
    return tc, model


def test_bootstrap_refuses_released_pt(tmp_path):
    """A released .pt is never eligible under the native topology, even
    when it is there."""
    tc, model = _native_model(eye_net_load_pretrained=True)
    (tmp_path / 'eve_eyenet_GRU.pt').write_bytes(b'not-a-real-checkpoint')
    with pytest.raises(FileNotFoundError, match='NOT weight-compatible'):
        harness.bootstrap_pretrained(tc, model, str(tmp_path))


def test_bootstrap_loads_native_npz_and_refuses_the_other_stem(tmp_path):
    from eve_tpu.train.checkpoint import flatten_tree
    trained = {which: jax.tree_util.tree_map(lambda x: x + 1.0,
                                             params('heatmap')[which])
               for which in ('eye_net', 'refine_net')}
    tc, model = _native_model(eye_net_load_pretrained=True,
                              refine_net_load_pretrained=True)
    for which, tree in trained.items():
        np.savez(tmp_path / tload.pretrained_filename(tc, which, '.npz'),
                 **flatten_tree(tree))
    assert harness.bootstrap_pretrained(tc, model, str(tmp_path)) == [
        'eye_net', 'refine_net']
    want = convert.eve_state_dict(trained)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # A stride-4 export under a patchify8 config: the '_tpu8' file is
    # missing, so it raises instead of loading the wrong stem's weights.
    tc8, model8 = _native_model(stem='patchify8',
                                eye_net_load_pretrained=True)
    with pytest.raises(FileNotFoundError, match='eve_eyenet_GRU_tpu8.npz'):
        harness.bootstrap_pretrained(tc8, model8, str(tmp_path))


def test_bootstrap_shape_guard(tmp_path):
    """A native file of another architecture raises eve_tpu's ValueError."""
    from eve_tpu.train.checkpoint import flatten_tree
    jspec, _ = _specs(eye_net_rnn_num_features=64)
    other = jax.jit(functools.partial(jeve.init_params, jspec))(
        jax.random.PRNGKey(0))['eye_net']
    tc, model = _native_model(eye_net_load_pretrained=True)
    np.savez(tmp_path / tload.pretrained_filename(tc, 'eye_net', '.npz'),
             **flatten_tree(jax.tree_util.tree_map(np.asarray, other)))
    with pytest.raises(ValueError, match='does not match the configured'):
        harness.bootstrap_pretrained(tc, model, str(tmp_path))


def test_initialiser_statistics_match_eve_tpu():
    """init_weights of the native modules: kaiming-normal (fan_out) stems
    and final_0, exact zeros for final_2 and gate_fc2, and lecun-normal
    (truncated at 2 standard deviations) for flax's gate_fc1."""
    _, tspec = _specs(head='gated')
    ours = teve.init_model(tspec, torch.Generator().manual_seed(0),
                           'cpu').state_dict()
    ref = convert.eve_state_dict(_init_tree())
    assert ours.keys() == ref.keys()
    for k, want in ref.items():
        got, want = ours[k].numpy(), want.numpy()
        if not want.any() or (want.size > 1 and np.all(want == want.flat[0])):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif want.size >= 4096:
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.05,
                                       err_msg=k)
    for k in ('refine_net.final_2.weight', 'refine_net.final_2.bias',
              'refine_net.gate_fc2.weight', 'refine_net.gate_fc2.bias',
              'refine_net.gate_fc1.bias', 'refine_net.stem.bias'):
        assert not ours[k].any(), k
    for k, fan_out in (('eye_net.cnn_layers.stem_conv.weight', 64 * 64),
                       ('refine_net.stem.weight', 128 * 16),
                       ('refine_net.final_0.weight', 64 * 9)):
        np.testing.assert_allclose(float(ours[k].std()),
                                   np.sqrt(2.0 / fan_out), rtol=0.05,
                                   err_msg=k)
    # lecun-normal over fan_in 64: std 1/8 after the truncation, every
    # element within 2 standard deviations of the untruncated normal.
    bound = 2 * (1 / 8) / .87962566103423978
    for fc1 in (ours['refine_net.gate_fc1.weight'].numpy(),
                ref['refine_net.gate_fc1.weight'].numpy()):
        assert fc1.shape == (32, 64)
        np.testing.assert_allclose(fc1.std(), 1 / 8, rtol=0.06)
        assert np.abs(fc1).max() <= bound + 1e-6
        assert np.abs(fc1).max() > 0.9 * bound
