"""The port's training harness on the CPU.

A run of ``configs/refine_net.json`` (frozen EyeNet, seeded init, 32x32
eyes, B = 2, T = 3) through ``Experiment``, ``init_datasets`` (spec tuples
of in-memory clips, ``tests/torch_clips.py``) and ``main_loop_iterator``
writes its run directory and checkpoints; a fresh
``Experiment`` resumed from the mid-run checkpoint takes the remaining
steps bitwise equal to the uninterrupted run under ``fully_reproducible``
(the same data order, kappas and optimizer state; the CPU's kernels are
deterministic). The NaN watchdog exits 1 before any save, a config that
asks for pretrained weights that are absent raises, and the scalar log
falls back to JSON lines without ``tensorboardX``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.train import harness
from eve_tpu_torch.train import logging_utils
from eve_tpu_torch.utils import convert
from tests.torch_clips import specs

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
STEPS = 4  # 8 training clips in batches of 2, one epoch


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)



def _config(**overrides):
    cfg = tconfig.Config()
    cfg.import_json(CONFIG)
    cfg.import_dict(dict({
        'eye_net_load_pretrained': False, 'batch_size': 2, 'num_epochs': 1.0,
        'max_sequence_len': 3, 'eyes_size': [32, 32],
        'fully_reproducible': True, 'train_data_workers': 2,
        'checkpoints_save_every_n_steps': 2, 'test_every_n_steps': 2,
        'test_num_samples': 3, 'test_batch_size': 2}, **overrides))
    return cfg


def _run(cfg, base, train_sets, test_sets):
    """One harness run: ``(experiment, {step: full_loss tensor})``."""
    train, test = harness.init_datasets(cfg, train_sets, test_sets)
    exp = harness.Experiment(cfg, output_dir_base=base, device='cpu')
    try:
        losses = {step: m['full_loss'] for step, m, _ in
                  harness.main_loop_iterator(exp, train, test)}
    finally:
        exp.close()
    return exp, losses


@pytest.fixture(scope='module')
def sets():
    return [specs('train', 0, 2 * STEPS)], [specs('val', 1, 4)]


@pytest.fixture(scope='module')
def whole_run(tmp_path_factory, sets):
    base = str(tmp_path_factory.mktemp('runs'))
    return base, _run(_config(), base, *sets)


def test_run_writes_its_directory_and_checkpoints(whole_run):
    base, (exp, losses) = whole_run
    assert sorted(losses) == list(range(STEPS))
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert exp.output_dir.startswith(os.path.join(base, 'EVE/'))
    files = sorted(os.listdir(exp.output_dir))
    assert 'messages.log' in files and 'checkpoints' in files
    with open(os.path.join(exp.output_dir, 'configs', 'combined.json')) as f:
        written = json.load(f)
    assert written['batch_size'] == 2 and written['learning_rate'] == 2 * \
        written['base_learning_rate']
    assert sorted(os.listdir(os.path.join(exp.output_dir, 'checkpoints'))) \
        == ['0000002.ckpt', '0000004.ckpt']
    # The frozen EyeNet leaves the run as it entered it; every RefineNet
    # tensor moves but the CLSTM's gates, whose state never reaches the
    # loss under clstm_carry_only (zero gradient, and weight_decay 0).
    init = teve.init_model(exp.spec, torch.Generator().manual_seed(0), 'cpu')
    sd = exp.state.model.state_dict()
    for k, v in init.state_dict().items():
        frozen = k.startswith('eye_net.') or '.rnn_cells.' in k
        assert torch.equal(v, sd[k]) == frozen, k


def test_resume_is_bitwise_equal_on_the_cpu(tmp_path, whole_run, sets):
    _, (exp, losses) = whole_run
    run_dir = str(tmp_path / 'resumed')
    shutil.copytree(os.path.join(exp.output_dir, 'checkpoints',
                                 '0000002.ckpt'),
                    os.path.join(run_dir, 'checkpoints', '0000002.ckpt'))
    exp2, resumed = _run(_config(resume_from=run_dir), str(tmp_path), *sets)
    assert exp2.output_dir == run_dir
    assert sorted(resumed) == [2, 3]
    for step, loss in resumed.items():
        assert torch.equal(loss, losses[step]), step
    a, b = exp.state.model.state_dict(), exp2.state.model.state_dict()
    for k, v in a.items():
        assert torch.equal(b[k], v), k
    assert exp2.state.step == exp.state.step == STEPS


def test_nan_watchdog_exits_before_any_save(tmp_path, sets, monkeypatch):
    def nan_step(state, batch, generator=None):
        state.step += 1
        return {'full_loss': torch.tensor(float('nan')),
                'nan_flag': torch.tensor(True)}

    monkeypatch.setattr(harness.step_lib, 'train_step', nan_step)
    cfg = _config(log_every_n_steps=100, tensorboard_scalars_every_n_steps=100)
    train, test = harness.init_datasets(cfg, *sets)
    exp = harness.Experiment(cfg, output_dir_base=str(tmp_path), device='cpu')
    with pytest.raises(SystemExit) as exit_info:
        for _ in harness.main_loop_iterator(exp, train, test):
            pass
    assert exit_info.value.code == 1
    # Step 2's periodic save was due; the watchdog ran first.
    assert not os.path.isdir(os.path.join(exp.output_dir, 'checkpoints')) \
        or not os.listdir(os.path.join(exp.output_dir, 'checkpoints'))


def test_missing_pretrained_weights_raise(tmp_path, monkeypatch):
    monkeypatch.delenv('EVE_PRETRAINED_DIR', raising=False)
    cfg = tconfig.Config()
    cfg.import_json(CONFIG)
    assert cfg.eye_net_load_pretrained
    spec = teve.EveSpec.from_config(cfg)
    model = teve.init_model(spec, torch.Generator().manual_seed(0), 'cpu')
    with pytest.raises(FileNotFoundError, match='refusing to train'):
        harness.bootstrap_pretrained(cfg, model, str(tmp_path))
    exp = harness.Experiment(cfg, str(tmp_path), device='cpu')
    try:
        with pytest.raises(FileNotFoundError, match='refusing to train'):
            exp.build_training(1)
    finally:
        exp.close()
    # The released .pt (a reference-named state dict) loads.
    released = teve.init_model(spec, torch.Generator().manual_seed(2), 'cpu')
    torch.save(released.eye_net.state_dict(), tmp_path / 'eve_eyenet_GRU.pt')
    assert harness.bootstrap_pretrained(cfg, model, str(tmp_path)) == \
        ['eye_net']
    for k, v in released.eye_net.state_dict().items():
        assert torch.equal(model.eye_net.state_dict()[k], v), k
    # An eve_tpu-native file loads, before the .pt beside it.
    other = teve.init_model(spec, torch.Generator().manual_seed(1), 'cpu')
    tree = convert.eve_params(other.state_dict())['eye_net']
    np.savez(tmp_path / 'eve_eyenet_GRU.npz', **tckpt.flatten_tree(tree))
    assert harness.bootstrap_pretrained(cfg, model, str(tmp_path)) == \
        ['eye_net']
    for k, v in other.eye_net.state_dict().items():
        assert torch.equal(model.eye_net.state_dict()[k], v), k


def test_pad_eval_batch_adds_invalid_clips():
    batch = {'x': np.arange(6.0).reshape(3, 2),
             'x_validity': np.ones((3, 2), bool), 'name': ['a', 'b', 'c']}
    out = harness._pad_eval_batch(batch, 5)
    assert out['x'].shape == (5, 2) and out['name'] == batch['name']
    np.testing.assert_array_equal(out['x'][3:], [[4.0, 5.0]] * 2)
    assert out['x_validity'][:3].all() and not out['x_validity'][3:].any()


def test_scalar_log_falls_back_to_json_lines(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'tensorboardX', None)
    board = logging_utils.Tensorboard(str(tmp_path))
    board.update_current_step(7)
    board.add_scalar('train/full_loss', torch.tensor(0.5))
    board.close()
    with open(tmp_path / 'scalars.jsonl') as f:
        (line,) = [json.loads(x) for x in f]
    assert (line['tag'], line['value'], line['step']) == \
        ('train/full_loss', 0.5, 7)
