"""Preemption and auto-resume of the port's training, on the CPU.

The cases of eve_tpu's ``tests/test_harness.py`` for its preemption path,
on the port's harness (``configs/refine_net.json``, frozen EyeNet, seeded
init, 32x32 eyes, B = 2, T = 3, in-memory clips):

- a real ``os.kill(SIGTERM)`` mid-training exits 143 with a checkpoint of
  the completed steps, and a resumed run starts there;
- the same during live validation and during the final full test;
- the handler replaces SIG_IGN and keeps an application's own handler;
- ``cleanup_and_quit`` clears a request that was not honoured, and a
  request made before the loop survives the handler's install;
- ``auto_resume`` continues the newest run of the same config hash that
  holds a checkpoint, skips one without, is not fooled by the flag itself
  (``--auto-resume yes`` hashes as the run it continues) and starts a
  changed config fresh;
- the command line: ``python -m eve_tpu_torch.cli.train`` on a synthetic
  EVE tree, SIGTERM after its log shows step 2, exits 143; the same argv
  plus ``--auto-resume yes`` continues the run, runs the final full test
  and exits 0;
- interrupted and resumed training equals uninterrupted training bitwise
  (``fully_reproducible``; the CPU's kernels are deterministic), with
  ``train_batch_echoing`` 1 and 2 (the interrupt lands mid echo group).
"""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from eve_tpu_torch import config as tconfig
from eve_tpu_torch.train import harness
from tests.torch_clips import specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'refine_net.json')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _sigterm():
    """Each test starts without a request and with SIGTERM's default
    disposition (a test file run before in the same process, such as the
    serving CLI's, may have left its handler), and leaves SIGTERM as it
    was."""
    old = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    harness._PREEMPTION.clear()
    yield
    harness._PREEMPTION.clear()
    signal.signal(signal.SIGTERM, old)


def _config(**overrides):
    cfg = tconfig.Config()
    cfg.import_json(CONFIG)
    cfg.import_dict(dict({
        'eye_net_load_pretrained': False, 'batch_size': 2, 'num_epochs': 1.0,
        'max_sequence_len': 3, 'eyes_size': [32, 32],
        'fully_reproducible': True, 'train_data_workers': 0,
        'checkpoints_save_every_n_steps': 1000, 'test_every_n_steps': 1000,
        'test_num_samples': 2, 'test_batch_size': 1,
        'full_test_batch_size': 2, 'full_test_data_workers': 0}, **overrides))
    return cfg


TRAIN, VAL = [specs('train', 0, 8)], [specs('val', 1, 3)]


def _start(cfg, base):
    train, test = harness.init_datasets(cfg, TRAIN, VAL)
    return harness.Experiment(cfg, output_dir_base=str(base),
                              device='cpu'), train, test


def _checkpoints(exp):
    return sorted(os.listdir(os.path.join(exp.output_dir, 'checkpoints')))


def _run_until_exit(exp, train, test, on_step=None):
    """Steps of a run that must exit 143: ``(steps, exit code)``."""
    executed = []
    with pytest.raises(SystemExit) as exit_info:
        for step, _, _ in harness.main_loop_iterator(exp, train, test):
            executed.append(step)
            if on_step is not None:
                on_step(step)
    return executed, exit_info.value.code


def test_sigterm_mid_training_checkpoints_the_completed_step(tmp_path):
    exp, train, test = _start(_config(), tmp_path)

    def kill_after_step_1(step):
        if step == 1:  # the installed handler takes the real signal
            os.kill(os.getpid(), signal.SIGTERM)

    executed, code = _run_until_exit(exp, train, test, kill_after_step_1)
    assert code == 143 and executed == [0, 1]
    assert _checkpoints(exp) == ['0000002.ckpt']
    assert not harness._PREEMPTION.is_set()
    # A restart resumes at the preemption step: 0 and 1 are not re-run.
    exp2, train2, test2 = _start(_config(resume_from=exp.output_dir),
                                 tmp_path)
    try:
        resumed = [s for s, _, _ in harness.main_loop_iterator(exp2, train2,
                                                               test2)]
    finally:
        exp2.close()
    assert resumed == [2, 3]


def test_sigterm_during_live_validation_counts_the_step(tmp_path,
                                                        monkeypatch):
    """Live validation runs in the iteration of the step before it, whose
    update is already applied: the checkpoint counts that step."""
    exp, train, test = _start(_config(test_every_n_steps=2), tmp_path)
    eval_step = harness.step_lib.eval_step
    calls = []

    def first_batch_then_signal(model, batch, create_images=False):
        out = eval_step(model, batch, create_images)
        calls.append(1)
        if len(calls) == 1:  # between the validation's two batches
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(harness.step_lib, 'eval_step',
                        first_batch_then_signal)
    executed, code = _run_until_exit(exp, train, test)
    assert code == 143 and executed == [0, 1] and len(calls) == 1
    assert _checkpoints(exp) == ['0000002.ckpt']


def test_sigterm_during_the_final_test_exits_143(tmp_path):
    exp, train, test = _start(_config(), tmp_path)
    steps = [s for s, _, _ in harness.main_loop_iterator(exp, train, test)]
    assert steps == [0, 1, 2, 3]
    harness.request_preemption_checkpoint()  # as the signal handler does
    with pytest.raises(SystemExit) as exit_info:
        harness.do_final_full_test(exp, test)
    assert exit_info.value.code == 143
    assert _checkpoints(exp) == ['0000004.ckpt']


def test_handler_replaces_sig_ign():
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    harness._install_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is \
        harness.request_preemption_checkpoint


def test_handler_keeps_an_applications_own():
    def own(signum, frame):
        pass

    signal.signal(signal.SIGTERM, own)
    harness._install_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is own
    assert not harness._PREEMPTION.is_set()


def test_cleanup_clears_a_request_not_honoured(tmp_path):
    exp = harness.Experiment(_config(), str(tmp_path), device='cpu')
    harness.request_preemption_checkpoint()
    with pytest.raises(SystemExit) as exit_info:
        harness.cleanup_and_quit(exp, exit_code=0)
    assert exit_info.value.code == 0
    assert not harness._PREEMPTION.is_set()


def test_request_before_the_loop_survives_the_install(tmp_path):
    exp, train, test = _start(_config(), tmp_path)
    harness.request_preemption_checkpoint()  # while the run is being built
    executed, code = _run_until_exit(exp, train, test)
    assert code == 143 and executed == [0]
    assert _checkpoints(exp) == ['0000001.ckpt']


def test_auto_resume_finds_the_same_configs_run(tmp_path, caplog):
    cfg = _config()
    cfg_hash = harness.config_identity_hash(cfg)
    family = tmp_path / 'EVE'
    older = family / ('260101_000000.' + cfg_hash)
    (older / 'checkpoints' / '0000002.ckpt').mkdir(parents=True)
    # Newer, but without a checkpoint (killed before its first save), and
    # newer still, of another config: neither is resumed.
    (family / ('260101_000001.' + cfg_hash)).mkdir()
    (family / '260101_000002.abcdef' / 'checkpoints' /
     '0000004.ckpt').mkdir(parents=True)
    assert harness._latest_resumable_run(str(family), cfg_hash) == str(older)

    # The flag is left out of the hash: the first launch ran without it.
    cfg.override('auto_resume', True)
    assert harness.config_identity_hash(cfg) == cfg_hash
    with caplog.at_level('INFO'):
        exp = harness.Experiment(cfg, str(tmp_path), device='cpu')
    exp.close()
    assert cfg.resume_from == exp.output_dir == str(older)
    assert exp.identifier == 'EVE/260101_000000.' + cfg_hash
    assert 'auto_resume: continuing %s' % older in caplog.text

    changed = _config(auto_resume=True, num_epochs=2.0)
    assert harness.config_identity_hash(changed) != cfg_hash
    fresh = harness.Experiment(changed, str(tmp_path), device='cpu')
    fresh.close()
    assert not changed.resume_from
    assert fresh.output_dir.startswith(str(family)) and \
        fresh.output_dir.endswith(harness.config_identity_hash(changed))


@pytest.fixture(scope='module')
def dataset_root(tmp_path_factory):
    from eve_tpu.data.synthetic import write_synthetic_dataset
    root = tmp_path_factory.mktemp('eve_preempt')
    write_synthetic_dataset(str(root), participants=('train01', 'val01'),
                            stimuli=('step008_image_test',
                                     'step009_image_test'),
                            num_frames=60, eyes_size=32)
    return str(root)


def _cli(argv, cwd):
    # Two threads, as the test processes hold torch to.
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2')
    return subprocess.Popen(
        [sys.executable, '-m', 'eve_tpu_torch.cli.train'] + argv, cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_exits_143_on_sigterm_and_auto_resumes(dataset_root, tmp_path):
    argv = [CONFIG, '--datasrc-eve', dataset_root, '--device', 'cpu',
            '--max-sequence-len', '6', '--eyes-size', '[32, 32]',
            '--eye-net-load-pretrained', 'no', '--batch-size', '2',
            '--num-epochs', '2', '--fully-reproducible', 'yes',
            '--train-data-workers', '0', '--test-data-workers', '0',
            '--full-test-data-workers', '0', '--full-test-batch-size', '2',
            '--test-num-samples', '2', '--test-batch-size', '2',
            '--train-cameras', '["webcam_c"]', '--test-cameras', '["webcam_c"]',
            '--train-stimuli', '["image"]', '--test-stimuli', '["image"]']
    first = _cli(argv, str(tmp_path))
    lines = []
    try:
        for line in first.stdout:
            lines.append(line)
            if 'Step 2,' in line:
                first.send_signal(signal.SIGTERM)
                break
        lines.extend(first.stdout)
        assert first.wait(timeout=120) == 143, ''.join(lines[-20:])
    finally:
        if first.poll() is None:
            first.kill()
    log = ''.join(lines)
    stop = int(re.search(r'checkpoint saved at step (\d+)', log).group(1))
    assert stop >= 2
    (run,) = os.listdir(tmp_path / 'outputs' / 'EVE')
    run_dir = os.path.join('./outputs', 'EVE', run)
    assert os.path.isdir(os.path.join(str(tmp_path), run_dir, 'checkpoints',
                                      '%07d.ckpt' % stop))

    second = _cli(argv + ['--auto-resume', 'yes'], str(tmp_path))
    out, _ = second.communicate(timeout=300)
    assert second.returncode == 0, out[-3000:]
    assert 'auto_resume: continuing %s' % run_dir in out
    steps = [int(s) for s in re.findall(r'Step (\d+), Epoch', out)]
    assert steps and steps[0] == stop + 1
    assert 'full_test:' in out
    assert os.listdir(tmp_path / 'outputs' / 'EVE') == [run]


def _losses_and_params(exp, train, test, interrupt_at=None):
    losses = {}
    for step, metrics, _ in harness.main_loop_iterator(exp, train, test):
        losses[step] = metrics['full_loss']
        if step == interrupt_at:
            harness.request_preemption_checkpoint()
    return losses, exp.state.model.state_dict()


@pytest.mark.parametrize('echo', [1, 2])
def test_interrupted_and_resumed_is_bitwise_equal(tmp_path, echo):
    cfg = dict(train_batch_echoing=echo, num_epochs=1.5)
    exp, train, test = _start(_config(**cfg), tmp_path / 'whole')
    try:
        whole, params = _losses_and_params(exp, train, test)
    finally:
        exp.close()
    assert sorted(whole) == list(range(6 * echo))
    interrupt = 2  # with echo 2: the first step of the second group
    exp, train, test = _start(_config(**cfg), tmp_path / 'cut')
    with pytest.raises(SystemExit) as exit_info:
        _losses_and_params(exp, train, test, interrupt_at=interrupt)
    assert exit_info.value.code == 143
    exp, train, test = _start(_config(resume_from=exp.output_dir, **cfg),
                              tmp_path / 'cut')
    try:
        resumed, resumed_params = _losses_and_params(exp, train, test)
    finally:
        exp.close()
    assert sorted(resumed) == list(range(interrupt + 1, 6 * echo))
    for step, loss in resumed.items():
        assert torch.equal(loss, whole[step]), step
    for k, v in params.items():
        assert torch.equal(resumed_params[k], v), k
    assert np.isfinite(float(whole[max(whole)]))
