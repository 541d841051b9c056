"""The port's training keys against eve_tpu's config.

Every key the port reads has eve_tpu's default, ``learning_rate`` is
derived as in eve_tpu, both shipped configs load unchanged, each group of
training options that the port does not implement yet raises on any value
but its default instead of being ignored, and each option that an earlier
slice left raising and this one ported (echoing, the profiler, both Google
Sheets keys, evaluation only, auto-resume) is accepted and reaches the
harness. Those cases run the harness on a tiny ``configs/refine_net.json``
(32x32 eyes, T = 3, B = 2) with the training step stubbed out.
"""

import logging
import os
import sys
import types

import pytest
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.train import harness
from tests.torch_clips import specs

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')


@pytest.fixture
def reference():
    DefaultConfig._reset_instance_for_testing()
    try:
        yield DefaultConfig()
    finally:
        DefaultConfig._reset_instance_for_testing()


def _differing(ours, theirs):
    """Keys whose values differ; the port's own keys (``PORT_KEYS``, which
    eve_tpu lacks) must hold the value that selects eve_tpu's model."""
    assert {k: ours[k] for k in tconfig.PORT_KEYS} == {'gaze_net': 'eve'}
    return {k: v for k, v in ours.items()
            if k not in tconfig.PORT_KEYS and theirs[k] != v}


def test_defaults_are_eve_tpus(reference):
    ours = tconfig.Config().get_all_key_values()
    theirs = reference.get_all_key_values()
    assert _differing(ours, theirs) == {}


@pytest.mark.parametrize('name', ['eye_net.json', 'refine_net.json'])
def test_shipped_configs_load_as_in_eve_tpu(name, reference):
    cfg = tconfig.Config()
    cfg.import_json(os.path.join(CONFIGS, name))
    reference.import_json(os.path.join(CONFIGS, name))
    theirs = reference.get_all_key_values()
    assert _differing(cfg.get_all_key_values(), theirs) == {}


def test_learning_rate_is_derived():
    cfg = tconfig.Config()
    cfg.import_dict({'batch_size': 8, 'base_learning_rate': 1e-4,
                     'learning_rate': 123.0})
    assert cfg.learning_rate == pytest.approx(8e-4)
    with pytest.raises(TypeError, match='learning_rate'):
        cfg.import_dict({'learning_rate': 'fast'})


# One case per group of training options that earlier slices left raising;
# every one is implemented now. Remat (tests/test_torch_remat.py): a value
# outside eve_tpu's set raises eve_tpu's ValueError. Multi-host
# (tests/test_torch_parallel_train.py), the sequence mesh and model
# parallelism (tests/test_torch_parallel_{seq,model}.py): eve_tpu's values
# are accepted and a badly typed value raises as for any key; a grid that
# cannot form raises eve_tpu's ValueError.
UNIMPLEMENTED_GROUPS = {
    'remat': {'tpu_remat': 'full'},
    'sequence mesh': {'tpu_sequence_shards': 2},
    'model parallelism': {'tpu_model_parallelism': 2},
    'multi-host': {'tpu_multihost': True},
}


@pytest.mark.parametrize('group', sorted(UNIMPLEMENTED_GROUPS))
def test_unimplemented_keys_raise_unless_default(group):
    ((key, value),) = UNIMPLEMENTED_GROUPS[group].items()
    cfg = tconfig.Config()
    assert not hasattr(tconfig, 'UNIMPLEMENTED_KEYS')
    if key == 'tpu_remat':
        cfg.import_dict({key: 'refine'})  # accepted
        with pytest.raises(ValueError, match=key):
            cfg.import_dict({key: value})
        return
    if key == 'tpu_multihost':
        cfg.import_dict({key: value, 'tpu_coordinator_address': 'h0:1234',
                         'tpu_num_processes': 2, 'tpu_process_id': 1})
        assert cfg.tpu_multihost and cfg.tpu_process_id == 1
        with pytest.raises(TypeError, match='tpu_num_processes'):
            cfg.import_dict({'tpu_num_processes': '2'})
        return
    cfg.import_dict({key: value})  # eve_tpu's value is accepted
    assert getattr(cfg, key) == value
    with pytest.raises(TypeError, match=key):
        cfg.import_dict({key: '2'})
    axis = {'tpu_sequence_shards': 'seq', 'tpu_model_parallelism': 'model'}
    assert harness.training_grid(cfg, 4) == {'data': 2, axis[key]: 2}
    with pytest.raises(ValueError, match='needs 2 devices, have 1'):
        harness.training_grid(cfg, 1)


class _Sheet:
    """A worksheet in memory: rows of cells, 1-based."""

    def __init__(self):
        self.rows = {}
        self.writes = []

    def row_values(self, i):
        return list(self.rows.get(i, []))

    def col_values(self, j):
        return [r[j - 1] for _, r in sorted(self.rows.items())
                if len(r) >= j]

    def update(self, where, values):
        row = int(where.split(':')[0])
        self.rows[row] = list(values[0])
        if row > 1:
            self.writes.append(dict(zip(self.rows[1], values[0])))


def _fake_gspread(monkeypatch):
    """gspread and oauth2client stand-ins that open one in-memory sheet."""
    sheet = _Sheet()
    workbook = types.SimpleNamespace(sheet1=sheet)
    client = types.SimpleNamespace(open_by_key=lambda key: workbook)
    monkeypatch.setitem(sys.modules, 'gspread', types.SimpleNamespace(
        authorize=lambda creds: client))
    service = types.ModuleType('oauth2client.service_account')
    service.ServiceAccountCredentials = types.SimpleNamespace(
        from_json_keyfile_name=lambda path, scope: path)
    monkeypatch.setitem(sys.modules, 'oauth2client',
                        types.ModuleType('oauth2client'))
    monkeypatch.setitem(sys.modules, 'oauth2client.service_account', service)
    return sheet


def _stub_step(state, batch, generator=None):
    state.step += 1
    return {'full_loss': torch.tensor(0.5), 'nan_flag': torch.tensor(False)}


def _harness_run(cfg, base, final_test=False):
    """init_datasets, Experiment, the loop (8 clips, batch 2, the training
    step stubbed out) and optionally the final full test;
    ``(experiment, steps, final test results)``."""
    train, test = harness.init_datasets(cfg, [specs('train', 0, 8)],
                                        [specs('val', 1, 2)])
    exp = harness.Experiment(cfg, str(base), device='cpu')
    try:
        steps = [s for s, _, _ in harness.main_loop_iterator(exp, train,
                                                             test)]
        results = (harness.do_final_full_test(exp, test) if final_test
                   else None)
    finally:
        exp.close()
    return exp, steps, results


def _check_echoing(cfg, tmp_path, monkeypatch, caplog):
    _, steps, _ = _harness_run(cfg, tmp_path)
    assert steps == list(range(8))  # 4 batches, each trained on twice


def _check_profiler(cfg, tmp_path, monkeypatch, caplog):
    cfg.override('num_epochs', 2.0)
    exp, steps, _ = _harness_run(cfg, tmp_path)
    assert len(steps) == 8
    assert os.path.isfile(os.path.join(exp.output_dir, 'model.txt'))
    assert os.listdir(cfg.profile_dir) == [
        'steps_0000006-0000008.pt.trace.json']


def _check_gsheet_secrets(cfg, tmp_path, monkeypatch, caplog):
    # Without gspread the logger is disabled, and the run goes on.
    monkeypatch.setitem(sys.modules, 'gspread', None)
    with caplog.at_level(logging.WARNING):
        exp, steps, _ = _harness_run(cfg, tmp_path)
    assert not exp.gsheet_logger.ready and len(steps) == 4
    assert 'GoogleSheetLogger disabled' in caplog.text


def _check_gsheet_workbook(cfg, tmp_path, monkeypatch, caplog):
    sheet = _fake_gspread(monkeypatch)
    exp, _, _ = _harness_run(cfg, tmp_path, final_test=True)
    assert exp.gsheet_logger.ready
    # One row for the run: registered, then rewritten after each test.
    assert len(sheet.rows) == 2
    rows = sheet.writes
    assert {r['Identifier'] for r in rows} == {exp.identifier}
    assert rows[0]['Start Time']
    live = [r for r in rows if r.get('Step') == 2.0]
    assert live and isinstance(live[0]['test/val/full_loss'], float)
    assert isinstance(rows[-1]['full_test/val/full_loss'], float)


def _check_eval_only(cfg, tmp_path, monkeypatch, caplog):
    exp, steps, results = _harness_run(cfg, tmp_path, final_test=True)
    assert steps == [] and exp.state is not None and exp.state.step == 0
    assert set(results) == {'val'} and 'full_loss' in results['val']


def _check_auto_resume(cfg, tmp_path, monkeypatch, caplog):
    first = tconfig.Config()
    first.import_dict({k: v for k, v in cfg.get_all_key_values().items()
                       if k not in ('learning_rate', 'auto_resume')})
    exp, _, _ = _harness_run(first, tmp_path)
    with caplog.at_level(logging.INFO):
        resumed, steps, _ = _harness_run(cfg, tmp_path)
    assert cfg.resume_from == exp.output_dir == resumed.output_dir
    assert steps == [] and resumed.state.step == 4
    assert 'auto_resume: continuing' in caplog.text


# Each option an earlier slice left raising: the key, a value, and what the
# harness does with it.
PORTED_GROUPS = {
    'echoing': ({'train_batch_echoing': 2}, _check_echoing),
    'profiler': ({'profile_dir': 'profile'}, _check_profiler),
    'gsheet secrets': ({'gsheet_secrets_json_file': 'secrets.json',
                        'gsheet_workbook_key': 'abc'}, _check_gsheet_secrets),
    'gsheet workbook': ({'gsheet_workbook_key': 'abc',
                         'gsheet_secrets_json_file': 'secrets.json',
                         'test_every_n_steps': 2}, _check_gsheet_workbook),
    'eval only': ({'skip_training': True}, _check_eval_only),
    'auto resume': ({'auto_resume': True}, _check_auto_resume),
}


@pytest.mark.parametrize('group', sorted(PORTED_GROUPS))
def test_ported_keys_are_accepted_and_reach_the_harness(
        group, tmp_path, monkeypatch, caplog):
    values, check = PORTED_GROUPS[group]
    if 'profile_dir' in values:
        values = dict(values, profile_dir=str(tmp_path / 'profile'))
    cfg = tconfig.Config()
    cfg.import_json(os.path.join(CONFIGS, 'refine_net.json'))
    cfg.import_dict({'eye_net_load_pretrained': False, 'batch_size': 2,
                     'num_epochs': 1.0, 'max_sequence_len': 3,
                     'eyes_size': [32, 32], 'fully_reproducible': True,
                     'train_data_workers': 0, 'test_every_n_steps': 1000,
                     'test_num_samples': 2, 'test_batch_size': 2,
                     'full_test_batch_size': 2, 'full_test_data_workers': 0})
    cfg.import_dict(values)  # accepted: no longer raises
    for key, value in values.items():
        assert getattr(cfg, key) == value
    monkeypatch.setattr(harness.step_lib, 'train_step', _stub_step)
    check(cfg, tmp_path, monkeypatch, caplog)


def test_remat_off_spellings_and_pallas_are_accepted():
    cfg = tconfig.Config()
    for off in (False, 'false', 'no', 'none'):
        cfg.import_dict({'tpu_remat': off})
    cfg.import_dict({'tpu_use_pallas': False})  # ignored for good
    cfg.import_dict({'tpu_use_pallas': True})
    with pytest.raises(ValueError, match='Unknown'):
        cfg.import_dict({'train_batch_echo': 2})
