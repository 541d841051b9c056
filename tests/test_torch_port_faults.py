"""Three faults of the port against eve_tpu, repaired, on the CPU.

- ``tpu_native_refine_head``: with RefineNet enabled, the port raises the
  ``ValueError`` eve_tpu raises when it builds the RefineNet
  (``eve_tpu/models/eve.py`` ``build_refine_net``): 'gated' without
  ``tpu_native_arch``, and any value but 'heatmap' or 'gated'. Without
  RefineNet neither package looks at the key.
- ``tpu_num_devices``: training runs on one device; above 1 the
  ``Experiment`` raises, as ``infer.model_setup`` does, and 0 ("all") with
  several GPUs visible logs that the run uses one.
- The final full test is logged at eve_tpu's step, ``last_step + 1``: the
  number of steps after a training loop, and one past the checkpoint's
  step when no step ran (``skip_training``, or the resume of a finished
  run), where the port used to log the checkpoint's step itself.

The runs train ``configs/eye_net.json`` on in-memory clips (32x32 eyes,
B = 2, T = 3) for 4 steps.
"""

import logging
import os

import pytest
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.models import eve as jeve
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import harness
from eve_tpu_torch.train import logging_utils
from tests.torch_clips import specs

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')
CONFIG = os.path.join(CONFIGS, 'refine_net.json')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# tpu_native_refine_head
# ----------------------------------------------------------------------

def _error(build):
    try:
        build()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize('refine', [True, False], ids=['refine', 'no_refine'])
@pytest.mark.parametrize('head', ['heatmap', 'gated', 'sigmoid'])
def test_refine_head_errors_match_eve_tpu(refine, head):
    overrides = {'refine_net_enabled': refine,
                 'tpu_native_refine_head': head}
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        jc.import_dict(overrides)
        theirs = _error(jeve.EveSpec.from_config(jc).build_refine_net)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict(overrides)
    ours = _error(lambda: teve.EveSpec.from_config(tc))
    assert (ours is None) == (theirs is None) == (not refine or
                                                  head == 'heatmap')
    if theirs is not None:
        # The same sentence up to eve_tpu's reason in parentheses.
        assert ours.split('(')[0] == theirs.split('(')[0]


def _config(**overrides):
    cfg = tconfig.Config()
    cfg.import_json(os.path.join(CONFIGS, 'eye_net.json'))
    cfg.import_dict(dict({
        'batch_size': 2, 'num_epochs': 1.0, 'max_sequence_len': 3,
        'eyes_size': [32, 32], 'fully_reproducible': True,
        'train_data_workers': 0, 'full_test_data_workers': 0,
        'full_test_batch_size': 2, 'checkpoints_save_every_n_steps': 2,
        'test_every_n_steps': 2, 'test_num_samples': 2,
        'test_batch_size': 2}, **overrides))
    return cfg


# ----------------------------------------------------------------------
# tpu_num_devices
# ----------------------------------------------------------------------

def test_training_refuses_more_than_one_device(tmp_path):
    with pytest.raises(NotImplementedError, match='tpu_num_devices=2'):
        harness.Experiment(_config(tpu_num_devices=2), str(tmp_path),
                           device='cpu')


@pytest.mark.parametrize('num_devices', [0, 1])
def test_all_devices_logs_that_the_run_uses_one(tmp_path, monkeypatch,
                                                caplog, num_devices):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    with caplog.at_level(logging.WARNING, logger=harness.__name__):
        exp = harness.Experiment(_config(tpu_num_devices=num_devices),
                                 str(tmp_path), device='cpu')
        exp.close()
    logged = '4 GPUs are visible, and the port trains on one' in caplog.text
    assert logged == (num_devices == 0)


# ----------------------------------------------------------------------
# The final full test's step
# ----------------------------------------------------------------------

@pytest.fixture
def final_test_steps(monkeypatch):
    """The TensorBoard steps the final full test's scalars land on."""
    steps = []
    add_scalar = logging_utils.Tensorboard.add_scalar

    def recorded(self, tag, value):
        if tag.startswith('full_test_'):
            steps.append(self.current_step)
        add_scalar(self, tag, value)

    monkeypatch.setattr(logging_utils.Tensorboard, 'add_scalar', recorded)
    return steps


def _train_and_test(cfg, base, steps):
    """Build, run the loop, run the final test: ``(loop steps, final-test
    TensorBoard steps)``."""
    train, test = harness.init_datasets(cfg, [specs('train', 0, 8)],
                                        [specs('val', 1, 4)])
    exp = harness.Experiment(cfg, output_dir_base=base, device='cpu')
    try:
        ran = [step for step, _, _ in
               harness.main_loop_iterator(exp, train, test)]
        del steps[:]
        harness.do_final_full_test(exp, test)
    finally:
        exp.close()
    return ran, sorted(set(steps)), exp.output_dir


def test_final_test_step_matches_eve_tpu(tmp_path, final_test_steps):
    """4 steps, then the final test at 4; the resume of the finished run
    (with and without ``skip_training``) at 5, one past its checkpoint at
    4; ``skip_training`` without a checkpoint at 1."""
    base = str(tmp_path)
    ran, logged, run_dir = _train_and_test(_config(), base, final_test_steps)
    assert (ran, logged) == ([0, 1, 2, 3], [4])
    for overrides in ({}, {'skip_training': True}):
        ran, logged, _ = _train_and_test(
            _config(resume_from=run_dir, **overrides), base,
            final_test_steps)
        assert (ran, logged) == ([], [5]), overrides
    ran, logged, _ = _train_and_test(_config(skip_training=True), base,
                                     final_test_steps)
    assert (ran, logged) == ([], [1])
