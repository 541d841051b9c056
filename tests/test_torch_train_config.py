"""The port's training keys against eve_tpu's config.

Every key the port reads has eve_tpu's default, ``learning_rate`` is
derived as in eve_tpu, both shipped configs load unchanged, and each group
of training options that the port does not implement yet raises on any
value but its default instead of being ignored.
"""

import os

import pytest

from eve_tpu.config import DefaultConfig
from eve_tpu_torch import config as tconfig

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')


@pytest.fixture
def reference():
    DefaultConfig._reset_instance_for_testing()
    try:
        yield DefaultConfig()
    finally:
        DefaultConfig._reset_instance_for_testing()


def test_defaults_are_eve_tpus(reference):
    ours = tconfig.Config().get_all_key_values()
    theirs = reference.get_all_key_values()
    assert {k: v for k, v in ours.items() if theirs[k] != v} == {}
    for k, v in tconfig.UNIMPLEMENTED_KEYS.items():
        want = theirs[k]
        if k == 'tpu_remat':
            want = tconfig._normalize_remat(want)
        assert v == want, k


@pytest.mark.parametrize('name', ['eye_net.json', 'refine_net.json'])
def test_shipped_configs_load_as_in_eve_tpu(name, reference):
    cfg = tconfig.Config()
    cfg.import_json(os.path.join(CONFIGS, name))
    reference.import_json(os.path.join(CONFIGS, name))
    theirs = reference.get_all_key_values()
    assert {k: v for k, v in cfg.get_all_key_values().items()
            if theirs[k] != v} == {}


def test_learning_rate_is_derived():
    cfg = tconfig.Config()
    cfg.import_dict({'batch_size': 8, 'base_learning_rate': 1e-4,
                     'learning_rate': 123.0})
    assert cfg.learning_rate == pytest.approx(8e-4)
    with pytest.raises(TypeError, match='learning_rate'):
        cfg.import_dict({'learning_rate': 'fast'})


# One case per group of training options of later slices.
UNIMPLEMENTED_GROUPS = {
    'echoing': {'train_batch_echoing': 2},
    'remat': {'tpu_remat': 'full'},
    'sequence mesh': {'tpu_sequence_shards': 2},
    'model parallelism': {'tpu_model_parallelism': 2},
    'multi-host': {'tpu_multihost': True},
    'profiler': {'profile_dir': '/profiles'},
    'gsheet secrets': {'gsheet_secrets_json_file': 'secrets.json'},
    'gsheet workbook': {'gsheet_workbook_key': 'abc'},
    'eval only': {'skip_training': True},
    'auto resume': {'auto_resume': True},
}


@pytest.mark.parametrize('group', sorted(UNIMPLEMENTED_GROUPS))
def test_unimplemented_keys_raise_unless_default(group):
    ((key, value),) = UNIMPLEMENTED_GROUPS[group].items()
    cfg = tconfig.Config()
    cfg.import_dict({key: tconfig.UNIMPLEMENTED_KEYS[key]})  # accepted
    with pytest.raises(NotImplementedError, match=key):
        cfg.import_dict({key: value})


def test_remat_off_spellings_and_pallas_are_accepted():
    cfg = tconfig.Config()
    for off in (False, 'false', 'no', 'none'):
        cfg.import_dict({'tpu_remat': off})
    cfg.import_dict({'tpu_use_pallas': False})  # ignored for good
    cfg.import_dict({'tpu_use_pallas': True})
    with pytest.raises(ValueError, match='Unknown'):
        cfg.import_dict({'train_batch_echo': 2})
