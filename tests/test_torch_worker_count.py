"""``cli.train.worker_count`` sizes eve_tpu's grid, on the CPU.

eve_tpu sizes its training grid from the global device count and the
global per-step batch (``eve_tpu/train/harness.py``'s ``Experiment``); the
port's launcher takes the same grid over hosts x local cards and starts
each host's share of its ranks. A table over hosts, local cards, batch,
accumulation, model and seq pins the count a host starts, and holds the
grid to the mesh eve_tpu's ``Experiment`` builds with that many devices
(``tpu_num_devices``, on its 8 virtual CPU devices): the same number of
ranks, or the same ``ValueError``. Where eve_tpu's grid does not split
evenly over the hosts (5 ranks over 2 hosts), the port raises, naming the
grid and the hosts: a difference by design (ROADMAP.md, Queue 3).
"""

import types

import numpy as np
import pytest
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.train import harness as jharness
from eve_tpu_torch.cli import train as train_cli

# (hosts, cards a host, batch_size, accumulation, model, seq) -> workers a
# host starts (None: the process trains itself), or the error's words.
TABLE = {
    (1, 4, 8, 1, 1, 1): 4,
    (1, 4, 6, 1, 1, 1): 3,
    (1, 4, 8, 4, 1, 1): 2,
    (1, 1, 8, 1, 1, 1): None,
    (1, 4, 8, 1, 2, 2): 4,
    (1, 4, 2, 1, 2, 1): 4,
    (2, 4, 8, 1, 1, 1): 4,
    (2, 4, 6, 1, 1, 1): 3,
    (2, 4, 8, 2, 1, 1): 2,
    (2, 4, 10, 1, 1, 1): "grid {'data': 5} of 5 ranks does not split over "
                         "the 2 hosts",
    (2, 4, 3, 1, 2, 1): 3,
    (2, 4, 8, 1, 2, 2): 4,
    (2, 2, 8, 1, 2, 1): 2,
    (2, 1, 8, 1, 1, 1): None,
    (4, 2, 2, 1, 1, 1): "grid {'data': 2} of 2 ranks does not split over "
                        "the 4 hosts",
    (2, 4, 8, 1, 3, 1): 'must divide the 8 available devices',
    (1, 4, 8, 1, 4, 2): 'needs 8 devices, have 4',
}


def _settings(hosts, cards, batch, accumulation, model, seq):
    return dict(batch_size=batch, gradient_accumulation_steps=accumulation,
                tpu_model_parallelism=model, tpu_sequence_shards=seq,
                max_sequence_len=30,
                tpu_num_devices=hosts * cards)


def _eve_tpus_ranks(settings, tmp_path):
    """The ranks of eve_tpu's mesh for ``settings``, or its ValueError."""
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_dict(settings)
        exp = jharness.Experiment(jc, output_dir_base=str(tmp_path))
        return int(np.prod(list(dict(exp.mesh.shape).values())))
    except ValueError as exc:
        return exc
    finally:
        DefaultConfig._reset_instance_for_testing()


@pytest.mark.parametrize('row', sorted(TABLE), ids=str)
def test_worker_count_is_eve_tpus_grid(row, tmp_path, monkeypatch):
    hosts, cards = row[:2]
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    settings = _settings(*row)
    config = types.SimpleNamespace(
        tpu_multihost=hosts > 1, tpu_num_processes=hosts,
        **dict(settings, tpu_num_devices=0))
    want = TABLE[row]
    theirs = _eve_tpus_ranks(settings, tmp_path)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want.replace(
                '{', r'\{').replace('}', r'\}')) as ours:
            train_cli.worker_count(config, 'cuda', env={})
        if isinstance(theirs, ValueError):
            assert str(ours.value) == str(theirs)
        else:  # eve_tpu's grid formed; the hosts cannot share it
            assert theirs % hosts and str(theirs) in str(ours.value)
        return
    count = train_cli.worker_count(config, 'cuda', env={})
    assert count == want
    assert (count or 1) * hosts == theirs
    # tpu_num_devices names the global count, as eve_tpu's does.
    config.tpu_num_devices = hosts * cards
    assert train_cli.worker_count(config, 'cuda', env={}) == want
