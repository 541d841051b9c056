"""The port's inference slice against eve_tpu's, on the CPU.

The ``configs/refine_net.json`` model (GRU EyeNet, CLSTM RefineNet with
screen content) gets eve_tpu's seed-0 weights with every parameter
perturbed (as in ``test_torch_eve.py``), carried into the port with
``utils.convert``. 32x32 eyes, T = 6, B = 2, uint8 frames as the dataset
reader emits them.

- ``forward(create_images=True)``: every image output against eve_tpu's;
- ``infer.iterator(streaming=True)`` against eve_tpu's on the same three
  consecutive clips of one video, and against one forward over the video;
- ``infer.model_setup`` from an eve_tpu run directory, and from the
  reference ``.pt`` files that eve_tpu's ``save_reference_checkpoint``
  writes, through both packages' loaders.

Tolerances, with their reasons:
- PoG in screen px: rtol 1e-4, atol 1e-2 px, as ``test_torch_eve.py``
  (the refined PoG is a beta = 100 soft-argmax of RefineNet's output, which
  sums ~25 float32 convolutions in another order than XLA's).
- Heatmaps: rtol 1e-4, atol 1e-4; values lie in [0, 1]. The initial maps
  differ as the PoG they are drawn at; the refined ones are RefineNet's
  sigmoid output through its 10x-kicked 1x1 head, where float32 rounding
  of ~25 convolutions reaches 6e-5.
- Histories: rtol 1e-4, atol T * 1e-4, a sum of at most T decayed maps.
- Everything else: rtol 1e-4, atol 1e-4.
- Weights loaded from files: bitwise.
"""

import functools
import os

import numpy as np
import pytest

import jax
import torch

from eve_tpu import infer as jinfer
from eve_tpu.config import DefaultConfig
from eve_tpu.data.loader import DataLoader as JDataLoader
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import eve as jeve
from eve_tpu.train.checkpoint import CheckpointManager
from eve_tpu.train.step import TrainState
from eve_tpu.utils import torch_convert
from eve_tpu_torch import config as tconfig
from eve_tpu_torch import infer
from eve_tpu_torch.data.loader import DataLoader
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import harness
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.utils import convert, load_model

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
EYE, B, T = 32, 2, 6
IMAGE_KEYS = {'screen_frame', 'initial_gaze_history', 'initial_heatmap',
              'final_heatmap', 'refined_gaze_history', 'gt_heatmap',
              'left_g_gt', 'PoG_px_gt', 'PoG_px_gt_validity',
              'left_g_initial', 'PoG_px_initial', 'g_final', 'PoG_px_final'}
HISTORY_KEYS = {'initial_gaze_history', 'refined_gaze_history'}
MAP_KEYS = HISTORY_KEYS | {'initial_heatmap', 'final_heatmap', 'gt_heatmap'}

torch.set_num_threads(2)


def _tolerance(key):
    if 'PoG_px' in key:
        return dict(rtol=1e-4, atol=1e-2)
    if key in HISTORY_KEYS:
        return dict(rtol=1e-4, atol=T * 1e-4)
    return dict(rtol=1e-4, atol=1e-4)


def _assert_outputs(ours, ref, what=''):
    assert set(ours) == set(ref), what
    for key in sorted(ref):
        got = np.asarray(ours[key])
        np.testing.assert_allclose(got.astype(np.float64),
                                   np.asarray(ref[key], np.float64),
                                   err_msg='%s %s' % (what, key),
                                   **_tolerance(key))


def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


def _jax_config(**overrides):
    DefaultConfig._reset_instance_for_testing()
    jc = DefaultConfig()
    jc.import_json(CONFIG)
    jc.import_dict(overrides)
    return jc


def _port_config(**overrides):
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict(overrides)
    return tc


@pytest.fixture(scope='module')
def specs():
    try:
        jspec = jeve.EveSpec.from_config(_jax_config())
    finally:
        DefaultConfig._reset_instance_for_testing()
    return jspec, teve.EveSpec.from_config(_port_config())


@pytest.fixture(scope='module')
def params(specs):
    tree = jax.jit(functools.partial(jeve.init_params, specs[0]))(
        jax.random.PRNGKey(0))
    tree = _perturb(tree, np.random.RandomState(0))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


@pytest.fixture(scope='module')
def model(specs, params):
    return teve.build_model(specs[1], convert.eve_state_dict(params), 'cpu')


@pytest.fixture
def clean_config():
    DefaultConfig._reset_instance_for_testing()
    yield
    DefaultConfig._reset_instance_for_testing()


def _batch(seed, batch_size=B, sequence_len=T):
    batch = make_synthetic_batch(np.random.RandomState(seed),
                                 batch_size=batch_size,
                                 sequence_len=sequence_len, eyes_size=EYE,
                                 frame_dtype=np.uint8)
    # Real stamps are int64 nanoseconds; the loader rebases them.
    batch['timestamps'] = (int(1.6e18) + np.arange(sequence_len) *
                           33333333 + 1000 * np.arange(
                               batch_size)[:, None]).astype(np.int64)
    return batch


def _rebased(batch):
    from eve_tpu_torch.data.loader import rebase_timestamps
    return dict(batch, timestamps=rebase_timestamps(batch['timestamps']))


@pytest.mark.parametrize('labels', [True, False], ids=['labels', 'no labels'])
def test_create_images_matches_eve_tpu(specs, params, model, labels):
    batch = _rebased(_batch(1))
    batch['left_PoG_tobii_validity'][0, 2] = 0
    batch['right_PoG_tobii_validity'][1, 4] = 0
    if not labels:
        batch = {k: v for k, v in batch.items()
                 if not k.endswith(('_tobii', '_tobii_validity', '_p',
                                    '_p_validity'))}
    fn = jax.jit(lambda p, b: jeve.forward(
        specs[0], p, b, training=False, output_predictions=True,
        create_images=True))
    ref = {k: np.asarray(v) for k, v in fn(params, batch).items()}
    with torch.inference_mode():
        ours = model(teve.batch_to_tensors(batch, 'cpu'),
                     output_predictions=True, create_images=True)
    ours = {k: v.numpy() for k, v in ours.items()}
    want = IMAGE_KEYS if labels else IMAGE_KEYS - MAP_KEYS - {
        'left_g_gt', 'PoG_px_gt', 'PoG_px_gt_validity'} | {
            'initial_heatmap', 'final_heatmap'}
    assert want <= set(ours)
    _assert_outputs(ours, ref)
    if labels:
        # The last frame's maps, the histories live.
        assert ours['initial_gaze_history'].shape == (B, 72, 128)
        assert np.ptp(ours['refined_gaze_history']) > 0.1
    # Without create_images the outputs are the serving forward's.
    with torch.inference_mode():
        plain = model(teve.batch_to_tensors(batch, 'cpu'),
                      output_predictions=True)
    assert set(plain) == set(ours) - (IMAGE_KEYS - {
        'PoG_px_initial', 'g_final', 'PoG_px_final'})


class _Clips:
    """Consecutive T-frame clips of one video, a dataset of dicts."""

    def __init__(self, video, t):
        n = video['left_eye_patch'].shape[1] // t
        self.clips = [dict({k: v[0, i * t:(i + 1) * t]
                            for k, v in video.items()},
                           participant='val01', subfolder='step008_x',
                           camera='webcam_c') for i in range(n)]

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def test_streaming_iterator_matches_eve_tpu_and_one_forward(specs, params,
                                                            model):
    video = _batch(2, batch_size=1, sequence_len=3 * T)
    clips = _Clips(video, T)
    ref = list(jinfer.iterator(specs[0], params, JDataLoader(
        clips, batch_size=1, num_workers=0), streaming=True))
    ours = list(infer.iterator(model, DataLoader(clips, batch_size=1,
                                                 num_workers=0),
                               streaming=True))
    assert len(ours) == len(ref) == 3
    for (step, inputs, outputs), (_, ref_in, ref_out) in zip(ours, ref):
        assert IMAGE_KEYS <= set(outputs)
        _assert_outputs(outputs, ref_out, 'chunk %d' % step)
        assert outputs['timestamps'].dtype == np.int64
        np.testing.assert_array_equal(outputs['timestamps'],
                                      video['timestamps'][:, step * T:
                                                          (step + 1) * T])
        assert set(inputs) == set(ref_in)
        for k, v in ref_in.items():
            np.testing.assert_array_equal(np.asarray(inputs[k]),
                                          np.asarray(v), err_msg=k)
    with torch.inference_mode():
        whole = model(teve.batch_to_tensors(_rebased(video), 'cpu'),
                      output_predictions=True)
    for key in ('PoG_px_initial', 'PoG_px_final', 'g_final',
                'left_pupil_size'):
        got = np.concatenate([o[key] for _, _, o in ours], axis=1)
        np.testing.assert_allclose(got, whole[key].numpy(), err_msg=key,
                                   **_tolerance(key))

    with pytest.raises(ValueError, match='one clip'):
        next(infer.iterator(model, DataLoader(clips, batch_size=2,
                                              num_workers=0),
                            streaming=True))
    # A mesh evaluates batches, not a stream (eve_tpu's ValueError).
    with pytest.raises(ValueError, match='streaming'):
        next(infer.iterator(model, [], streaming=True, mesh=2))


def test_iterator_ragged_batch_and_no_inputs(model):
    """A ragged final batch runs at its own size and gives the clips'
    full-batch outputs; ``materialize_inputs=False`` returns the strings
    and the int64 stamps only."""
    clips = _Clips(_batch(4, batch_size=1, sequence_len=3 * T), T)
    full = list(infer.iterator(model, DataLoader(clips, batch_size=3,
                                                 num_workers=0),
                               create_images=False))
    ragged = list(infer.iterator(model, DataLoader(clips, batch_size=2,
                                                   num_workers=0),
                                 create_images=False,
                                 materialize_inputs=False))
    assert [o['PoG_px_final'].shape[0] for _, _, o in ragged] == [2, 1]
    got = {k: np.concatenate([o[k] for _, _, o in ragged])
           for k in ('PoG_px_initial', 'PoG_px_final', 'timestamps')}
    for k, v in got.items():
        np.testing.assert_allclose(v, full[0][2][k], err_msg=k,
                                   **_tolerance(k))
    assert set(ragged[1][1]) == {'participant', 'subfolder', 'camera',
                                 'timestamps_ns'}


def test_model_setup_reads_an_eve_tpu_run(params, tmp_path, clean_config):
    run = str(tmp_path / 'run')
    CheckpointManager(run).save_at_step(
        3, TrainState(step=np.int32(3), params=params, opt_state=()))
    cfg = _port_config(resume_from=run)
    model = infer.model_setup(cfg, device='cpu')
    assert not model.training
    want = convert.eve_state_dict(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # eve_tpu reads the same run to the same values.
    _, jparams = jinfer.model_setup(_jax_config(resume_from=run))
    for k, v in convert.eve_state_dict(jparams).items():
        assert torch.equal(got[k], v), k
    # Several devices: the same model, which infer.iterator(mesh=)
    # replicates (tests/test_torch_parallel_eval.py).
    several = infer.model_setup(
        _port_config(resume_from=run, tpu_num_devices=2), device='cpu')
    for k, v in several.state_dict().items():
        assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError):
        infer.model_setup(_port_config(resume_from=str(tmp_path / 'none')),
                          device='cpu')


def test_released_pt_weights_load_through_both_loaders(
        params, tmp_path, monkeypatch, clean_config):
    monkeypatch.delenv('EVE_PRETRAINED_DIR', raising=False)
    empty, pdir = tmp_path / 'empty', tmp_path / 'pretrained'
    empty.mkdir()
    pdir.mkdir()
    jc, tc = _jax_config(), _port_config()
    eye_pt = load_model.pretrained_filename(tc, 'eye_net', '.pt')
    refine_pt = load_model.pretrained_filename(tc, 'refine_net', '.pt')
    assert (eye_pt, refine_pt) == (
        'eve_eyenet_GRU.pt', 'eve_refinenet_CLSTM_oa_skip.pt')
    from eve_tpu.utils.load_model import pretrained_filename as jname
    assert jname(jc, 'eye_net') == eye_pt
    assert jname(jc, 'refine_net') == refine_pt

    for d, missing in ((empty, 'eye_net'), (pdir, 'refine_net')):
        if d is pdir:
            torch_convert.save_reference_checkpoint(
                str(pdir / eye_pt), params['eye_net'], 'eye_net')
        with pytest.raises(RuntimeError, match=missing):
            infer.model_setup(tc, require_weights=True, device='cpu',
                              pretrained_dir=str(d))
        with pytest.raises(RuntimeError, match=missing):
            jinfer.model_setup(jc, pretrained_dir=str(d),
                               require_weights=True)
    # EyeNet alone suffices once RefineNet is off.
    eye_only = _port_config(refine_net_enabled=False,
                            load_screen_content=False)
    assert infer.model_setup(eye_only, require_weights=True, device='cpu',
                             pretrained_dir=str(pdir)).refine_net is None

    torch_convert.save_reference_checkpoint(
        str(pdir / refine_pt), params['refine_net'], 'refine_net')
    got = infer.model_setup(tc, require_weights=True, device='cpu',
                            pretrained_dir=str(pdir)).state_dict()
    _, jparams = jinfer.model_setup(jc, pretrained_dir=str(pdir),
                                    require_weights=True)
    for want in (convert.eve_state_dict(params),
                 convert.eve_state_dict(jparams)):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    # A checkpoint-style file with the submodule prefix loads too, and the
    # training bootstrap reads the released file.
    sd = torch.load(str(pdir / eye_pt), weights_only=True)
    torch.save({'eye_net.' + k: v for k, v in sd.items()},
               str(empty / eye_pt))
    loaded = load_model.load_pretrained(tc, 'eye_net', str(empty))
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
    spec = teve.EveSpec.from_config(tc)
    fresh = teve.init_model(spec, torch.Generator().manual_seed(1), 'cpu')
    monkeypatch.setenv('EVE_PRETRAINED_DIR', str(pdir))
    assert harness.bootstrap_pretrained(tc, fresh) == ['eye_net']
    for k, v in sd.items():
        assert torch.equal(fresh.eye_net.state_dict()[k], v), k

    # eve_tpu's native .npz is preferred over the .pt beside it.
    other = teve.init_model(spec, torch.Generator().manual_seed(2), 'cpu')
    tree = convert.eve_params(other.state_dict())['eye_net']
    np.savez(pdir / load_model.pretrained_filename(tc, 'eye_net', '.npz'),
             **tckpt.flatten_tree(tree))
    model = infer.model_setup(tc, device='cpu', pretrained_dir=str(pdir))
    for k, v in other.eye_net.state_dict().items():
        assert torch.equal(model.eye_net.state_dict()[k], v), k


@pytest.mark.parametrize('materialize', [True, False],
                         ids=['copied in step', 'prefetched'])
def test_iterator_spans_with_a_profiler(model, materialize):
    """Under a profiler each batch gives one ``infer.batch`` with one
    ``infer.h2d`` and one ``infer.d2h`` child, and the outputs equal the
    same batches' with no profiler, bit for bit, on the step-by-step path
    and on the prefetched one (``materialize_inputs=False``)."""
    from eve_tpu_torch import tracing
    from tests.test_torch_tracing import all_threads_profiler
    clips = _Clips(_batch(5, batch_size=1, sequence_len=3 * T), T)

    def run():
        return list(infer.iterator(
            model, DataLoader(clips, batch_size=2, num_workers=0),
            create_images=False, materialize_inputs=materialize))
    plain = run()
    tracing.clear()
    with all_threads_profiler():
        traced = run()
    found = tracing.spans()
    tracing.clear()
    for (_, _, want), (_, _, got) in zip(plain, traced):
        assert set(want) == set(got)
        for k in want:
            assert np.array_equal(want[k], got[k]), k
    roots = [s for s in found if s.name == 'infer.batch']
    assert len(roots) == len(traced) == 2
    for root in roots:
        kids = [s for s in found if s.parent == root.id]
        assert sorted(s.name for s in kids) == ['infer.d2h', 'infer.h2d']
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in kids)


def test_prefetched_iterator_equals_the_copy_in_step(model):
    """The evaluation path (``materialize_inputs=False``, the copy-in
    ``DevicePrefetcher``'s) gives the step-by-step path's outputs bit for
    bit, and a consumer that stops after one batch leaves no loading
    thread behind."""
    import threading
    import time
    clips = _Clips(_batch(6, batch_size=1, sequence_len=4 * T), T)

    def run(materialize):
        return list(infer.iterator(
            model, DataLoader(clips, batch_size=1, num_workers=0),
            create_images=False, materialize_inputs=materialize))
    step, prefetched = run(True), run(False)
    assert len(step) == len(prefetched) == 4
    for (i, _, want), (j, got_in, got) in zip(step, prefetched):
        assert i == j and set(want) == set(got)
        for k in want:
            assert np.array_equal(want[k], got[k]), k
        assert 'left_eye_patch' not in got_in
    before = threading.active_count()
    batches = infer.iterator(model, DataLoader(clips, batch_size=1,
                                               num_workers=0),
                             create_images=False, materialize_inputs=False)
    next(batches)
    assert threading.active_count() == before + 1
    batches.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
