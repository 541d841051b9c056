"""The port's training command line against eve_tpu's, on the CPU.

- ``harness.script_init_common`` parses the same argv into the same values
  as eve_tpu's (JSON files, then flags) and seeds numpy's global stream
  with 0 as eve_tpu does.
- Both CLIs end to end on one ``write_synthetic_dataset`` tree (32x32
  eyes, T = 6, 8 training clips, B = 2, 4 steps with a checkpoint and a
  live validation every 2, the final full test on the 8 validation clips),
  from the same pretrained EyeNet and RefineNet files (seeded, perturbed
  weights in eve_tpu's ``.npz`` form, through ``$EVE_PRETRAINED_DIR``),
  without the kappa augmentation (the two packages draw from different
  random streams) and at base_learning_rate 1e-5. Each exit code is 0, and
  the final-test scalars agree: those of the frozen EyeNet's initial
  estimate within rtol 1e-5 (float32 sums in other orders; measured
  2e-7), those of RefineNet's trained estimate (``*_final``,
  ``full_loss``) within rtol 1e-3 (measured 3e-4): Adam moves every
  element by up to its LR of 2e-5 an update whatever the gradient's size,
  so an element whose gradient lies within rounding of 0 steps either way
  in the two frameworks, 4 times.
- The run directory: ``configs/`` holds ``combined.json``, ``config.py``
  and ``refine_net.json`` as eve_tpu's does, ``combined.json`` holds
  eve_tpu's values, and ``src.zip`` the port's Python, JSON and CUDA
  sources.
- ``--skip-training yes --resume-from <run>``: no step, and the final test
  of the run's weights, bitwise the trained run's own.
- Without ``--device``, the CLI runs on ``cuda`` and raises where there is
  no card.
"""

import json
import os
import shutil
import sys
import zipfile

import numpy as np
import pytest
import torch

from eve_tpu.cli import train as jtrain
from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import write_synthetic_dataset
from eve_tpu.train import harness as jharness
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.cli import train
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import harness
from eve_tpu_torch.train.checkpoint import flatten_tree
from eve_tpu_torch.utils import convert, load_model

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
# Final-test scalars: those of the frozen EyeNet's initial estimate, and
# those RefineNet's trained weights reach (see the module docstring).
FROZEN_RTOL, REFINED_RTOL = 1e-5, 1e-3


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _flags(root):
    return [CONFIG, '--datasrc-eve', root, '--max-sequence-len', '6',
            '--assumed-frame-rate', '10', '--eyes-size', '[32, 32]',
            '--batch-size', '2', '--num-epochs', '1',
            '--train-data-workers', '0', '--test-data-workers', '0',
            '--full-test-data-workers', '0', '--full-test-batch-size', '2',
            '--test-batch-size', '2', '--test-num-samples', '2',
            '--checkpoints-save-every-n-steps', '2',
            '--test-every-n-steps', '2', '--tpu-num-devices', '1',
            '--refine-net-load-pretrained', 'yes',
            '--refine-net-do-offset-augmentation', 'no',
            '--base-learning-rate', '1e-5', '--fully-reproducible', 'yes',
            '--train-cameras', '["webcam_c"]', '--test-cameras',
            '["webcam_c"]', '--train-stimuli', '["image"]',
            '--test-stimuli', '["image"]',
            # eve_tpu's reader then emits uint8 frames, as the port's
            # always does (the port's reader ignores the key).
            '--tpu-on-device-preprocess', 'yes']


def test_script_init_common_matches_eve_tpu():
    argv = [CONFIG, '--batch-size', '4', '--refine-net-enabled', 'yes',
            '--train-cameras', '["webcam_c"]', '--gaze-heatmap-sigma-final',
            '4', '--auto-resume', 'yes', '--train-batch-echoing', '2',
            '--profile-dir', 'p', '--full-test-batch-size', '8']
    DefaultConfig._reset_instance_for_testing()
    try:
        theirs = jharness.script_init_common(argv).get_all_key_values()
        want_draw = np.random.rand()
    finally:
        DefaultConfig._reset_instance_for_testing()
    config, args = harness.script_init_common(argv + ['--device', 'cpu'])
    assert np.random.rand() == want_draw  # both seeded numpy with 0
    ours = config.get_all_key_values()
    # The port's own keys (eve_tpu lacks them) at the value that selects
    # eve_tpu's model.
    assert {k: ours.pop(k) for k in tconfig.PORT_KEYS} == {'gaze_net': 'eve'}
    assert {k: v for k, v in ours.items() if theirs[k] != v} == {}
    assert (config.batch_size, config.auto_resume, args.device) == (
        4, True, 'cpu')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both CLIs on one tree from the same weights: ``{package: (exit
    code, final-test results, run directory, tree, pretrained dir)}``."""
    base = tmp_path_factory.mktemp('cli')
    root = str(base / 'data')
    write_synthetic_dataset(root, participants=('train01', 'val01'),
                            stimuli=('step008_image_test',
                                     'step009_image_test'),
                            num_frames=60, eyes_size=32)
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict({'refine_net_do_offset_augmentation': False})
    model = teve.init_model(teve.EveSpec.from_config(tc),
                            torch.Generator().manual_seed(3), 'cpu')
    rng = np.random.RandomState(0)
    tree = convert.eve_params(model.state_dict())
    tree = {which: {k: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
                    for k, v in flatten_tree(sub).items()}
            for which, sub in tree.items()}
    tree['refine_net']['final_2/kernel'] *= 10.0
    pretrained = base / 'pretrained'
    pretrained.mkdir()
    for which, flat in tree.items():
        np.savez(pretrained / load_model.pretrained_filename(tc, which,
                                                              '.npz'), **flat)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('EVE_PRETRAINED_DIR', str(pretrained))
        for name in ('eve_tpu', 'port'):
            workdir = base / name
            workdir.mkdir()
            mp.chdir(workdir)
            results = {}
            if name == 'eve_tpu':
                inner = jharness.test_model_on_all

                def recorded(exp, test_data, step, log_key_prefix='test'):
                    final, sheet = inner(exp, test_data, step,
                                         log_key_prefix)
                    results[log_key_prefix] = final
                    return final, sheet

                mp.setattr(jharness, 'test_model_on_all', recorded)
                mp.setattr(sys, 'argv', ['train.py'] + _flags(root))
                DefaultConfig._reset_instance_for_testing()
                try:
                    with pytest.raises(SystemExit) as exit_info:
                        jtrain.main()
                finally:
                    DefaultConfig._reset_instance_for_testing()
            else:
                final_test = harness.do_final_full_test

                def recorded(exp, test_data):
                    results['full_test'] = final_test(exp, test_data)
                    return results['full_test']

                mp.setattr(harness, 'do_final_full_test', recorded)
                with pytest.raises(SystemExit) as exit_info:
                    train.main(_flags(root) + ['--device', 'cpu'])
            (run,) = os.listdir(workdir / 'outputs' / 'EVE')
            out[name] = (exit_info.value.code, results['full_test'],
                         str(workdir / 'outputs' / 'EVE' / run), root,
                         str(pretrained))
    return out


def test_final_test_scalars_match_eve_tpu(runs):
    code, ours = runs['port'][:2]
    their_code, theirs = runs['eve_tpu'][:2]
    assert code == their_code == 0
    assert list(ours) == list(theirs) == ['eve_val']
    ours, theirs = ours['eve_val'], theirs['eve_val']
    assert set(ours) == set(theirs)
    assert 'metric_euc_PoG_px_final' in ours
    for k, want in theirs.items():
        refined = 'final' in k or k == 'full_loss'
        np.testing.assert_allclose(
            ours[k], want, rtol=REFINED_RTOL if refined else FROZEN_RTOL,
            atol=0, err_msg=k)


def test_run_directory_provenance(runs):
    ours, theirs = runs['port'][2], runs['eve_tpu'][2]
    assert sorted(os.listdir(os.path.join(ours, 'configs'))) == sorted(
        os.listdir(os.path.join(theirs, 'configs'))) == [
        'combined.json', 'config.py', 'refine_net.json']
    with open(os.path.join(ours, 'configs', 'refine_net.json')) as f, \
            open(CONFIG) as g:
        assert f.read() == g.read()
    with open(os.path.join(ours, 'configs', 'combined.json')) as f:
        combined = json.load(f)
    with open(os.path.join(theirs, 'configs', 'combined.json')) as f:
        reference = json.load(f)
    assert set(combined) == set(tconfig.Config.keys())
    assert {k: combined.pop(k) for k in tconfig.PORT_KEYS} == {
        'gaze_net': 'eve'}
    assert {k: v for k, v in combined.items() if reference[k] != v} == {}
    with zipfile.ZipFile(os.path.join(ours, 'src.zip')) as zf:
        names = set(zf.namelist())
    assert {'eve_tpu_torch/cli/train.py', 'eve_tpu_torch/train/harness.py',
            'eve_tpu_torch/csrc/heatmap_kernels.cu',
            'eve_tpu_torch/csrc/hopper_async.cuh'} <= names
    assert not any(n.startswith('eve_tpu/') for n in names)
    assert sorted(os.listdir(os.path.join(ours, 'checkpoints'))) == [
        '0000002.ckpt', '0000004.ckpt']


def test_skip_training_tests_the_runs_weights(runs, tmp_path, monkeypatch):
    _, trained, run, root, pretrained = runs['port']
    resumed = str(tmp_path / 'run')
    shutil.copytree(run, resumed)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('EVE_PRETRAINED_DIR', pretrained)
    results = {}
    final_test = harness.do_final_full_test
    steps = []
    loop = harness.main_loop_iterator

    def counted(*args):
        for item in loop(*args):
            steps.append(item[0])
            yield item

    def recorded(exp, test_data):
        results['full_test'] = final_test(exp, test_data)
        return results['full_test']

    monkeypatch.setattr(harness, 'main_loop_iterator', counted)
    monkeypatch.setattr(harness, 'do_final_full_test', recorded)
    with pytest.raises(SystemExit) as exit_info:
        train.main(_flags(root) + ['--device', 'cpu', '--skip-training',
                                   'yes', '--resume-from', resumed])
    assert exit_info.value.code == 0 and steps == []
    assert results['full_test'] == trained


def test_without_device_it_runs_on_cuda(runs, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is visible: the run would train on it')
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        train.main(_flags(runs['port'][3]))
