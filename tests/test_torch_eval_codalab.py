"""The port's Codalab and inference CLIs end to end on the CPU, against eve_tpu.

One synthetic EVE tree (``val01`` and ``test01``, 40 frames at 30 fps,
32x32 eyes; clips of T = 6 at 10 Hz, so each video is 3 clips, the last
one 2 frames padded to 6) and one run directory that eve_tpu's
``CheckpointManager`` writes from eve_tpu's seed-0 weights, every one
perturbed. Shared flags: ``configs/refine_net.json``, 32x32 eyes, T = 6.

- ``python -m eve_tpu_torch.cli.eval_codalab --device cpu`` and eve_tpu's
  ``main`` at batch size 2 (one full batch, one ragged): the same pickle
  nesting, keys and lengths; timestamps exactly equal (int64 stamps read
  from the dataset); PoG in screen px within rtol 1e-4 + atol 1e-2 px and
  pupil sizes within rtol 1e-4 + atol 1e-4, the tolerances of
  ``test_torch_eve.py`` (float32 summed in another order than XLA's).
- ``python -m eve_tpu_torch.cli.inference --device cpu``, with and without
  streaming: an mp4 of 3 clips x 6 frames, and every frame it encodes
  equal, bit for bit, to eve_tpu's ``draw_pog_overlay`` drawing the same
  PoGs on the same screen recording (eve_tpu's CLI loop, re-stated below).
"""

import functools
import glob
import gzip
import os
import pickle
import shutil
import sys
import zipfile

import numpy as np
import pytest

import jax

from eve_tpu.cli import eval_codalab as jeval
from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import write_synthetic_dataset
from eve_tpu.models import eve as jeve
from eve_tpu.train.checkpoint import CheckpointManager
from eve_tpu.train.step import TrainState
from eve_tpu.utils import visualization as jvis
from eve_tpu_torch.cli import eval_codalab, inference

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
T = 6


@pytest.fixture(scope='module')
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('eve_codalab')
    write_synthetic_dataset(str(root), participants=('val01', 'test01'),
                            num_frames=40, eyes_size=32)
    return str(root)


@pytest.fixture(scope='module')
def run_dir(tmp_path_factory):
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        spec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    params = jax.jit(functools.partial(jeve.init_params, spec))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.05, np.shape(v))).astype(
            np.float32), params)
    params['refine_net']['final_2']['kernel'] *= 10.0
    run = str(tmp_path_factory.mktemp('run'))
    CheckpointManager(run).save_at_step(
        1, TrainState(step=np.int32(1), params=params, opt_state=()))
    return run


def _flags(root):
    return [CONFIG, '--datasrc-eve', root, '--max-sequence-len', str(T),
            '--assumed-frame-rate', '10', '--eyes-size', '[32, 32]']


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    DefaultConfig._reset_instance_for_testing()
    yield tmp_path
    DefaultConfig._reset_instance_for_testing()


def _read_submission(run):
    (pkl,) = glob.glob(os.path.join(run, 'for_codalab_*.pkl.gz'))
    with zipfile.ZipFile(pkl[:-len('.pkl.gz')] + '.zip') as zf:
        assert zf.namelist() == [os.path.basename(pkl)]
        with zf.open(os.path.basename(pkl)) as f:
            assert f.read() == open(pkl, 'rb').read()
    with gzip.open(pkl, 'rb') as f:
        return pickle.load(f)


def test_eval_codalab_main_matches_eve_tpu(dataset_root, run_dir, workdir,
                                           monkeypatch):
    flags = _flags(dataset_root) + ['--codalab-eval-batch-size', '2',
                                    '--codalab-eval-data-workers', '0']
    runs = {}
    for name in ('eve_tpu', 'port'):
        runs[name] = str(workdir / name)
        shutil.copytree(run_dir, runs[name])
    monkeypatch.setattr(sys, 'argv', ['eval_codalab.py'] + flags + [
        '--resume-from', runs['eve_tpu'], '--tpu-num-devices', '1'])
    jeval.main()
    # The port reads the segmentation cache eve_tpu wrote in this cwd.
    zip_path = eval_codalab.main(flags + ['--resume-from', runs['port'],
                                          '--device', 'cpu'])
    assert os.path.dirname(zip_path) == runs['port']
    ref, ours = (_read_submission(runs[n]) for n in ('eve_tpu', 'port'))

    assert list(ours) == list(ref) == ['test01']
    seq = ours['test01']['step008_image_test']['webcam_c']
    assert sorted(seq) == sorted(eval_codalab.KEYS_TO_STORE)
    assert seq['timestamps'].shape == (3 * T,)
    assert seq['PoG_px_final'].shape == (3 * T, 2)
    want = ref['test01']['step008_image_test']['webcam_c']
    assert seq['timestamps'].dtype == want['timestamps'].dtype == np.int64
    np.testing.assert_array_equal(seq['timestamps'], want['timestamps'])
    for key in ('left_pupil_size', 'right_pupil_size', 'PoG_px_initial',
                'PoG_px_final'):
        atol = 1e-2 if 'PoG' in key else 1e-4
        np.testing.assert_allclose(seq[key], want[key], rtol=1e-4,
                                   atol=atol, err_msg=key)
    assert np.ptp(seq['PoG_px_final'][:14]) > 1.0

    with pytest.raises(ValueError, match='--resume-from'):
        eval_codalab.main(flags + ['--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='tpu_num_devices'):
        eval_codalab.main(flags + ['--resume-from', runs['port'],
                                   '--device', 'cpu',
                                   '--tpu-num-devices', '2'])


def _eve_tpu_frames(inputs, outputs, actual_screen_size):
    """eve_tpu/cli/inference.py's drawing loop, with its own functions."""
    screens = inputs['screen_full_frame']
    canvas_h, canvas_w = screens.shape[2:4]
    aw, ah = actual_screen_size
    scale = np.array([canvas_w / aw, canvas_h / ah], np.float32)
    init = np.asarray(outputs['PoG_px_initial']) * scale
    final = np.asarray(outputs['PoG_px_final']) * scale
    gt = np.asarray(outputs['PoG_px_gt']) * scale
    validity = outputs['PoG_px_gt_validity']
    eyes = np.concatenate([inputs['right_eye_patch'],
                           inputs['left_eye_patch']], axis=3)
    frames = []
    for b in range(init.shape[0]):
        ones = np.ones(T, bool)
        to_draw = [('Initial Estimate', init[b], ones, jvis.COLOR_INITIAL),
                   ('After Refinement (Ours)', final[b], ones,
                    jvis.COLOR_FINAL),
                   ('Tobii Data (Groundtruth)', gt[b],
                    validity[b].astype(bool), jvis.COLOR_GT)]
        for t in range(T):
            frame = np.ascontiguousarray(screens[b, t][:, :, ::-1])
            jvis.draw_pog_overlay(frame, to_draw,
                                  eyes_bgr=eyes[b, t][:, :, ::-1],
                                  draw_gt_lines=True, gt=gt[b],
                                  gt_validity=validity[b].astype(bool),
                                  t=t, ui_scale=canvas_w / aw)
            frames.append(frame)
    return frames


@pytest.mark.parametrize('streaming', ['no', 'yes'])
def test_inference_cli_writes_eve_tpus_overlay(dataset_root, run_dir,
                                               workdir, monkeypatch,
                                               streaming):
    import cv2
    batches, written = [], []
    iterator = inference.infer.iterator
    write = inference.VideoEncoder.write

    def recording_iterator(*args, **kwargs):
        for item in iterator(*args, **kwargs):
            batches.append(item)
            yield item

    def recording_write(self, frame):
        written.append(frame.copy())
        write(self, frame)

    monkeypatch.setattr(inference.infer, 'iterator', recording_iterator)
    monkeypatch.setattr(inference.VideoEncoder, 'write', recording_write)
    out = str(workdir / 'overlay' / 'out.mp4')
    inference.main(_flags(dataset_root) + [
        '--input-path', os.path.join(dataset_root, 'val01',
                                     'step008_image_test', 'webcam_c.mp4'),
        '--output-path', out, '--resume-from', run_dir, '--device', 'cpu',
        '--inference-streaming', streaming])

    cap = cv2.VideoCapture(out)
    try:
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3 * T
        assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (384, 216)
    finally:
        cap.release()
    assert len(batches) == 3 and len(written) == 3 * T
    want = [f for _, inputs, outputs in batches
            for f in _eve_tpu_frames(inputs, outputs, (1920, 1080))]
    for i, (got, ref) in enumerate(zip(written, want)):
        np.testing.assert_array_equal(got, ref, err_msg='frame %d' % i)
    # The overlay drew something: frames differ from the bare recording.
    screen = batches[0][1]['screen_full_frame'][0, 0][:, :, ::-1]
    assert (written[0] != screen).any()
