"""The port's decode-once frame cache against eve_tpu's, on the CPU.

- Keys are eve_tpu's (SHA-1 of path, mtime_ns, size, output size, frame
  indices, format version 1) and the layout ``<k[:2]>/<k>.npz`` is too, so
  an entry either package writes is read by the other, bitwise.
- A corrupt entry is a miss and is deleted; a missing video keys to None.
- The budget evicts the least recently written entries down to 90% of it.
- The reader with ``frame_cache_dir``: a training item equals the uncached
  item bitwise, its windows land in the cache, a second reader serves them
  without decoding, and eve_tpu's reader (``tpu_on_device_preprocess``,
  the port's uint8 layout) reads the port's entries.
"""

import os
import time

import numpy as np
import pytest

from eve_tpu.config import DefaultConfig
from eve_tpu.data import dataset as jdataset
from eve_tpu.data.framecache import FrameDiskCache as JaxCache
from eve_tpu.data.synthetic import write_synthetic_dataset
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.data import dataset as tdataset
from eve_tpu_torch.data.framecache import FrameDiskCache


def _window(seed, n=4, h=6, w=10):
    rng = np.random.RandomState(seed)
    return (np.arange(n, dtype=np.int64) * 33333333 + seed,
            rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8))


def test_entries_are_shared_with_eve_tpu(tmp_path):
    video = tmp_path / 'webcam_c_eyes.mp4'
    video.write_bytes(b'not decoded here')
    ours = FrameDiskCache(str(tmp_path / 'cache'), budget_gb=1.0)
    theirs = JaxCache(str(tmp_path / 'cache'), budget_gb=1.0)
    key = ours.key(str(video), [3, 6, 9], (64, 32))
    assert key == theirs.key(str(video), (3, 6, 9), [64, 32])
    assert ours.key(str(tmp_path / 'missing.mp4'), [0], None) is None
    ts, frames = _window(1)
    ours.put(key, ts, frames)
    assert os.path.isfile(tmp_path / 'cache' / key[:2] / (key + '.npz'))
    got = theirs.get(key)
    np.testing.assert_array_equal(got[0], ts)
    np.testing.assert_array_equal(got[1], frames)
    other = theirs.key(str(video), [4, 7], (64, 32))
    ts2, frames2 = _window(2)
    theirs.put(other, ts2, frames2)
    got = ours.get(other)
    np.testing.assert_array_equal(got[0], ts2)
    np.testing.assert_array_equal(got[1], frames2)
    assert ours.get(ours.key(str(video), [5], (64, 32))) is None


def test_corrupt_entry_is_a_miss(tmp_path):
    cache = FrameDiskCache(str(tmp_path), budget_gb=1.0)
    key = 'ab' + '0' * 38
    cache.put(key, *_window(3))
    path = tmp_path / key[:2] / (key + '.npz')
    path.write_bytes(path.read_bytes()[:50])  # truncated
    assert cache.get(key) is None
    assert not path.exists()
    assert cache.get(None) is None


def test_budget_evicts_the_oldest(tmp_path):
    root = tmp_path / 'cache'
    cache = FrameDiskCache(str(root), budget_gb=1.0)
    keys = ['%02x' % i + '0' * 38 for i in range(6)]
    for i, key in enumerate(keys):
        cache.put(key, *_window(i, n=8, h=32, w=32))
        path = root / key[:2] / (key + '.npz')
        os.utime(path, ns=(time.time_ns(), 10 ** 18 + i * 10 ** 9))
    size = os.path.getsize(root / keys[0][:2] / (keys[0] + '.npz'))
    # Room for 3.5 entries: down to 90% of it, so three stay: the newest.
    cache = FrameDiskCache(str(root), budget_gb=3.5 * size / 2 ** 30)
    kept = [k for k in keys if cache.get(k) is not None]
    assert kept == keys[3:]


@pytest.fixture(scope='module')
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('eve_framecache')
    write_synthetic_dataset(str(root), participants=('train01',),
                            num_frames=40, eyes_size=32)
    return str(root)


def _port_config(**overrides):
    cfg = tconfig.Config()
    cfg.import_dict(dict({'max_sequence_len': 6, 'eyes_size': [32, 32]},
                         **overrides))
    return cfg


def test_reader_uses_the_cache(dataset_root, tmp_path, monkeypatch):
    cache_dir = str(tmp_path / 'frames')
    segmentation = str(tmp_path / 'segmentation')
    kwargs = dict(cameras_to_use=['webcam_c'], types_of_stimuli=['image'],
                  cache_dir=segmentation)
    plain = tdataset.EVESequences_train(dataset_root, config=_port_config(),
                                        **kwargs)
    cached = tdataset.EVESequences_train(
        dataset_root, config=_port_config(frame_cache_dir=cache_dir),
        **kwargs)
    assert len(plain) == len(cached) >= 2
    items = [plain[i] for i in range(len(plain))]
    for i, want in enumerate(items):
        got = cached[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    entries = [f for _, _, files in os.walk(cache_dir) for f in files]
    assert len(entries) == len(plain) and all(
        f.endswith('.npz') for f in entries)

    # A second reader serves every window from the cache, without a decode.
    def no_decode(*args, **kwargs):
        raise AssertionError('decoded a cached window')

    monkeypatch.setattr(tdataset, 'VideoReader', no_decode)
    again = tdataset.EVESequences_train(
        dataset_root, config=_port_config(frame_cache_dir=cache_dir),
        **kwargs)
    np.testing.assert_array_equal(again[1]['left_eye_patch'],
                                  items[1]['left_eye_patch'])

    # eve_tpu's reader reads the port's entries.
    monkeypatch.setattr(jdataset, 'VideoReader', no_decode)
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_dict({'max_sequence_len': 6, 'eyes_size': [32, 32],
                        'frame_cache_dir': cache_dir,
                        'tpu_on_device_preprocess': True})
        theirs = jdataset.EVESequences_train(dataset_root, config=jc,
                                             **kwargs)
        np.testing.assert_array_equal(theirs[0]['left_eye_patch'],
                                      items[0]['left_eye_patch'])
        np.testing.assert_array_equal(theirs[0]['timestamps'],
                                      items[0]['timestamps'])
    finally:
        DefaultConfig._reset_instance_for_testing()
