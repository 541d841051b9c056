"""Training images, the scalar/image log and the profiler window, on the CPU.

- ``compose_training_images`` against eve_tpu's on the same
  ``create_images`` outputs, for the shipped configs' equal sizes, a 2x
  shrink and a shrink by a non-integer factor: the same tags, and every
  image (each normalised to [0, 1]) within 3e-5. eve_tpu resizes the
  histories with ``cv2.resize(INTER_LINEAR)``, the port with
  ``interpolate(mode='bilinear', align_corners=False)``: both take the same
  two taps with the same weights, but cv2 places the source coordinate in
  double precision and torch in float32, which moves a weight by up to
  ~1e-5 at a non-integer factor (both agree to 2.4e-7 at 2x). The clamp
  comes after the resize in both.
- The harness yields eve_tpu's image tags at ``tensorboard_images_every_n_
  steps`` (with screen content), each finite in [0, 1], and nothing in
  between.
- ``Tensorboard.add_image`` writes through tensorboardX and is a no-op on
  the JSON-lines fallback; ``add_graph`` writes the module tree.
- With ``profile_dir`` the loop writes a Chrome trace of steps +5..+10,
  stopped at the end of a run shorter than the window too, with the train
  step's spans in it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from eve_tpu.train.logging_utils import (
    compose_training_images as jcompose, make_grid as jmake_grid)
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.train import harness
from eve_tpu_torch.train import logging_utils
from tests.torch_clips import specs

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
TAGS = {'train/screen_plus_initial_history',
        'train/screen_plus_refined_history', 'train/0_gt_heatmap',
        'train/1_initial_heatmap', 'train/2_final_heatmap'}


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _outputs(rng, b=3, screen=(72, 128)):
    """``create_images`` outputs: histories exceeding 1 near fixations."""
    h, w = 72, 128
    return {
        'screen_frame': rng.uniform(0, 1, (b,) + screen + (3,)),
        'initial_gaze_history': rng.uniform(0, 3, (b, h, w)),
        'refined_gaze_history': rng.uniform(0, 1.5, (b, h, w)),
        'gt_heatmap': rng.uniform(0, 1, (b, h, w)),
        'initial_heatmap': rng.uniform(0, 1, (b, h, w)),
        'final_heatmap': rng.uniform(-2, 4, (b, h, w)),
    }


@pytest.mark.parametrize('screen_size', [(128, 72), (64, 36), (100, 45)],
                         ids=['same', 'half', 'non-integer'])
def test_compose_matches_eve_tpu(screen_size):
    w, h = screen_size
    outputs = {k: v.astype(np.float32) for k, v in _outputs(
        np.random.RandomState(0), screen=(h, w)).items()}
    want = jcompose(outputs, screen_size=screen_size)
    got = logging_utils.compose_training_images(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        screen_size=screen_size)
    assert set(got) == set(want) == TAGS
    for tag, img in want.items():
        assert got[tag].shape == img.shape, tag
        np.testing.assert_allclose(got[tag], img, rtol=0, atol=3e-5,
                                   err_msg=tag)


def test_make_grid_is_eve_tpus():
    images = np.random.RandomState(1).uniform(-1, 3, (11, 5, 7, 3))
    for kwargs in ({}, {'normalize': True}, {'normalize': True,
                                             'scale_each': True, 'nrow': 4}):
        np.testing.assert_array_equal(
            logging_utils.make_grid(images, **kwargs),
            jmake_grid(images, **kwargs))


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


def _run(cfg, base):
    train, test = harness.init_datasets(cfg, [specs('train', 0, 8)],
                                        [specs('val', 1, 2)])
    exp = harness.Experiment(cfg, str(base), device='cpu')
    try:
        images = {s: i for s, _, i in harness.main_loop_iterator(exp, train,
                                                                 test)}
    finally:
        exp.close()
    return exp, images


def test_loop_yields_images_at_their_interval(tmp_path):
    _, images = _run(_config(tensorboard_images_every_n_steps=2), tmp_path)
    assert sorted(images) == [0, 1, 2, 3]
    assert not images[0] and not images[2]
    for step in (1, 3):
        assert set(images[step]) == TAGS
        for tag, img in images[step].items():
            assert img.ndim == 3 and img.shape[-1] == 3, tag
            assert np.isfinite(img).all() and img.min() >= 0 and \
                img.max() <= 1, tag
    # 2 clips: each history composite stacks three 72x128 frames.
    assert images[1]['train/screen_plus_initial_history'].shape == (
        3 * 72 + 2 * 2, 2 * 128 + 3 * 2, 3)


def test_add_image_and_graph(tmp_path, monkeypatch):
    board = logging_utils.Tensorboard(str(tmp_path / 'tbx'))
    board.update_current_step(3)
    board.add_image('train/x', np.random.RandomState(0).uniform(
        0, 1, (8, 9, 3)))
    board.add_grid('train/g', np.zeros((4, 5, 5)))
    board.add_graph(torch.nn.Sequential(torch.nn.Linear(2, 3)))
    board.close()
    assert any(f.startswith('events.out.tfevents')
               for f in os.listdir(tmp_path / 'tbx'))
    with open(tmp_path / 'tbx' / 'model.txt') as f:
        assert 'Linear(in_features=2, out_features=3' in f.read()

    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    board = logging_utils.Tensorboard(str(tmp_path / 'jsonl'))
    board.add_image('train/x', np.zeros((8, 9, 3)))  # dropped
    board.add_scalar('train/a', 1.0)
    board.close()
    with open(tmp_path / 'jsonl' / 'scalars.jsonl') as f:
        assert [json.loads(x)['tag'] for x in f] == ['train/a']


def test_profile_dir_writes_a_trace(tmp_path):
    profile_dir = tmp_path / 'profile'
    exp, _ = _run(_config(num_epochs=2.0, profile_dir=str(profile_dir)),
                  tmp_path)
    # 8 steps: the window opens before step 6 and the end of the run
    # closes it.
    assert os.listdir(profile_dir) == ['steps_0000006-0000008.pt.trace.json']
    with open(profile_dir / 'steps_0000006-0000008.pt.trace.json') as f:
        trace = json.load(f)
    assert trace['traceEvents']
    # The train step's spans come with the window, one set a step.
    names = [e.get('name') for e in trace['traceEvents']]
    assert [names.count('train.' + n) for n in
            ('step', 'forward', 'backward', 'update')] == [3, 3, 3, 3]
    assert os.path.isfile(os.path.join(exp.output_dir, 'model.txt'))
