"""The port's data loader against eve_tpu's, on the CPU.

The shuffled order for a seed and epoch is eve_tpu's exactly (the same
stateless numpy shuffle), ``fast_forward`` puts a resumed loader where the
uninterrupted one stood, and ``rebase_timestamps``/``collate`` equal
eve_tpu's bitwise. The prefetcher yields the loader's batches as tensors
and releases its thread when the consumer stops early.
"""

import threading
import time

import numpy as np
import pytest
import torch

from eve_tpu.data import loader as jloader
from eve_tpu_torch.data import loader as tloader


class _Clips:
    """Per-clip dicts with an index, float64 and int64 arrays and a
    timestamp row (with one padded frame)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'idx': np.array(i), 'x': np.full((3, 2), i, np.float64),
                'count': np.array([i, i + 1], np.int64),
                'timestamps': np.array([10 ** 18 + i, 10 ** 18 + i + 33,
                                        0], np.int64),
                'participant': 'p%02d' % i}


@pytest.mark.parametrize('workers', [0, 3])
@pytest.mark.parametrize('drop_last', [False, True])
def test_order_matches_eve_tpu(workers, drop_last):
    data = _Clips(23)
    ours = tloader.DataLoader(data, 4, shuffle=True, drop_last=drop_last,
                              num_workers=workers, seed=7)
    ref = jloader.DataLoader(data, 4, shuffle=True, drop_last=drop_last,
                             num_workers=workers, seed=7)
    assert len(ours) == len(ref)
    for _ in range(3):  # three epochs, each its own order
        got = [b['idx'].tolist() for b in ours]
        assert got == [b['idx'].tolist() for b in ref]
        assert ours.epoch == ref.epoch
    assert got != sorted(sum(got, []))


def test_fast_forward_resumes_the_stream():
    data = _Clips(10)
    whole = tloader.DataLoader(data, 3, shuffle=True, drop_last=True, seed=1)
    stream = [b['idx'].tolist() for _ in range(3) for b in whole]
    for drawn in (0, 2, 3, 5):
        resumed = tloader.DataLoader(data, 3, shuffle=True, drop_last=True,
                                     seed=1)
        resumed.fast_forward(drawn)
        rest = [b['idx'].tolist() for _ in range(3) for b in resumed]
        assert rest[:len(stream) - drawn] == stream[drawn:]


def test_collate_and_timestamps_match_eve_tpu():
    data = _Clips(5)
    items = [data[i] for i in (3, 1, 4)]
    ours, ref = tloader.collate(items), jloader.collate(items)
    assert ours.keys() == ref.keys()
    assert ours['participant'] == ref['participant'] == ['p03', 'p01', 'p04']
    for k in ('idx', 'x', 'count', 'timestamps'):
        np.testing.assert_array_equal(ours[k], ref[k])
    rebased = tloader.rebase_timestamps(ours['timestamps'])
    np.testing.assert_array_equal(rebased,
                                  jloader.rebase_timestamps(ref['timestamps']))
    np.testing.assert_array_equal(rebased[0], [1.0, 34.0, 0.0])
    tensors, extras = tloader.split_host_batch(ours)
    assert tensors['x'].dtype == torch.float32
    assert tensors['count'].dtype == torch.int32
    assert tensors['timestamps'].dtype == torch.float32
    assert extras['participant'] == ['p03', 'p01', 'p04']
    np.testing.assert_array_equal(extras['timestamps_ns'], ours['timestamps'])


def test_prefetcher_yields_the_batches_and_stops_cleanly():
    data = _Clips(12)
    loader = tloader.DataLoader(data, 2, num_workers=2)
    got = [(t['idx'].tolist(), e['participant'])
           for t, e in tloader.DevicePrefetcher(loader, 'cpu')]
    assert [g[0] for g in got] == [[i, i + 1] for i in range(0, 12, 2)]
    assert got[0][1] == ['p00', 'p01']

    # Abandoned after one batch: the producer thread gives up its puts.
    before = threading.active_count()
    it = iter(tloader.DevicePrefetcher(loader, 'cpu', depth=1))
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetcher_reraises_loader_errors():
    class Broken(_Clips):
        def __getitem__(self, i):
            if i == 3:
                raise RuntimeError('bad clip')
            return super().__getitem__(i)

    loader = tloader.DataLoader(Broken(6), 2)
    with pytest.raises(RuntimeError, match='bad clip'):
        list(tloader.DevicePrefetcher(loader, 'cpu'))
