"""The port's EVE dataset reader against eve_tpu's, on the CPU.

One synthetic EVE tree (``eve_tpu.data.synthetic.write_synthetic_dataset``:
``val01`` and ``test01``, 40 frames at 30 fps, 32x32 eyes) is read by both
packages with the same settings, eve_tpu with
``tpu_on_device_preprocess=True`` (uint8 frames, the layout the port always
emits). Both decode through the same backend (cv2 here, with no ffmpeg
binary), so every array of every item, the int64 timestamps included, must
be equal bit for bit, as must the segmentation cache and the ffmpeg pipe
commands.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest

from eve_tpu.config import DefaultConfig
from eve_tpu.data import dataset as jdataset
from eve_tpu.data import segmentation as jseg
from eve_tpu.data import video as jvideo
from eve_tpu.data.synthetic import _write_video, write_synthetic_dataset
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.data import dataset as tdataset
from eve_tpu_torch.data import segmentation as tseg
from eve_tpu_torch.data import video as tvideo

SETTINGS = {'max_sequence_len': 6, 'assumed_frame_rate': 10,
            'eyes_size': [32, 32], 'load_screen_content': True}


@pytest.fixture(scope='module')
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('eve_reader')
    write_synthetic_dataset(str(root), participants=('val01', 'test01'),
                            num_frames=40, eyes_size=32)
    return str(root)


@pytest.fixture
def configs(tmp_path, monkeypatch):
    """``make(**overrides) -> (eve_tpu config, port config)``; the
    segmentation caches go under ``tmp_path``."""
    monkeypatch.chdir(tmp_path)

    def make(**overrides):
        settings = dict(SETTINGS, **overrides)
        DefaultConfig._reset_instance_for_testing()
        jc = DefaultConfig()
        jc.import_dict(dict(settings, tpu_on_device_preprocess=True))
        tc = tconfig.Config()
        tc.import_dict(settings)
        return jc, tc

    yield make
    DefaultConfig._reset_instance_for_testing()


def _assert_items_equal(ours, ref, what):
    assert sorted(ours) == sorted(ref), what
    for key in ref:
        if isinstance(ref[key], str):
            assert ours[key] == ref[key], (what, key)
            continue
        assert ours[key].dtype == ref[key].dtype, (what, key)
        np.testing.assert_array_equal(ours[key], ref[key],
                                      err_msg='%s %s' % (what, key))


def test_segmentation_matches_and_cache_is_shared(dataset_root, tmp_path):
    ref = jseg.build_segmentation_cache(dataset_root, 10, 6,
                                        str(tmp_path / 'jax'))
    ours = tseg.build_segmentation_cache(dataset_root, 10, 6,
                                         str(tmp_path / 'torch'))
    assert ours == ref
    assert ours['test01']['step008_image_test']['webcam_c'][-1] == [36, 39]
    # Same file name and pickle: the port reads eve_tpu's cache as is.
    with open(jseg.cache_path(str(tmp_path / 'jax'), 10, 6), 'rb') as f:
        raw = f.read()
    assert tseg.cache_path(str(tmp_path / 'jax'), 10, 6).endswith(
        '10Hz_seqlen6.pkl')
    assert tseg.load_or_build_cache(dataset_root, 10, 6,
                                    str(tmp_path / 'jax')) == pickle.loads(raw)
    for kw in ({}, {'stimulus_name_includes': 'image'},
               {'require_screen': True}):
        args = (ref, dataset_root, ['val01', 'test01'], ['webcam_c'],
                ['image'])
        assert tseg.select_sequences(*args, **kw) == \
            jseg.select_sequences(*args, **kw)


# (participants, dataset options, config overrides)
READER_CASES = {
    'val windows with full frames': (
        ['val01'], {}, {'load_full_frame_for_visualization': True}),
    'test final-test LRU': (['test01'], {'is_final_test': True}, {}),
    'live validation cache': (['val01'], {'live_validation': True}, {}),
    'no screen': (['val01', 'test01'], {}, {'load_screen_content': False}),
    'full camera frames': (['test01'], {}, {'camera_frame_type': 'full'}),
}


@pytest.mark.parametrize('case', sorted(READER_CASES))
def test_every_item_matches_eve_tpu(dataset_root, configs, case):
    participants, options, overrides = READER_CASES[case]
    jc, tc = configs(**overrides)
    ref = jdataset.EVESequencesBase(dataset_root, config=jc,
                                    participants_to_use=participants,
                                    **options)
    ours = tdataset.EVESequencesBase(dataset_root, config=tc,
                                     participants_to_use=participants,
                                     **options)
    assert len(ours) == len(ref) > 0
    for i in list(range(len(ref))) + [0]:  # a repeat reads the caches
        got, want = ours[i], ref[i]
        _assert_items_equal(got, want, '%s item %d' % (case, i))
        frames = got.get('left_eye_patch', got.get('frame'))
        assert frames.dtype == np.uint8 and frames.shape[0] == 6
        assert got['timestamps'].dtype == np.int64


def test_split_classes_and_truncated_video(dataset_root, configs, tmp_path):
    """The test split's reader on a copy whose eye video lost its tail:
    the missing frames come back zero-padded with zero validity."""
    root = str(tmp_path / 'truncated')
    shutil.copytree(dataset_root, root)
    d = os.path.join(root, 'test01', 'step008_image_test')
    frames = jvideo.VideoReader(os.path.join(d, 'webcam_c_eyes.mp4'),
                                backend='cv2').get_frames()[1]
    _write_video(os.path.join(d, 'webcam_c_eyes.mp4'),
                 frames[:30], 30)
    for is_final_test in (False, True):
        jc, tc = configs()
        ref = jdataset.EVESequences_test(root, config=jc,
                                         is_final_test=is_final_test)
        ours = tdataset.EVESequences_test(root, config=tc,
                                          is_final_test=is_final_test)
        assert len(ours) == len(ref) == 3
        for i in range(3):
            _assert_items_equal(ours[i], ref[i], 'truncated item %d' % i)
        last = ours[2]
        assert not last['left_PoG_tobii_validity'].any()
        assert not last['left_eye_patch'].any()
    for cls, split in ((tdataset.EVESequences_train, 'train'),
                       (tdataset.EVESequences_val, 'val')):
        assert cls(root, config=tc).participants_to_use[0] == split + '01'


@pytest.mark.parametrize('case', [
    (None, None, None, True),
    ([0, 3, 6], (64, 32), None, True),
    ([90, 93, 96], (64, 32), 30.0, True),      # a late window: seek
    ([90, 93, 96], None, 30.0, False),         # seek off
    ([30, 33], (128, 72), 30.0, True),         # under 2 s in: no seek
    ([61, 64, 67], (256, 256), 29.97, True),
    ([5, 5, 2], None, None, True),             # duplicates, out of order
    ([], None, 30.0, True),
])
def test_ffmpeg_pipe_cmd_matches(case):
    indices, size, fps, seek = case
    ours = tvideo.ffmpeg_pipe_cmd('v.mp4', indices, size, fps, seek=seek)
    assert ours == jvideo.ffmpeg_pipe_cmd('v.mp4', indices, size, fps,
                                          seek=seek)


def test_timestamps_paths_and_seek_modes(monkeypatch):
    for path in ('a/webcam_c_eyes.mp4', 'a/basler_face.mp4',
                 'a/screen.128x72.mp4', 'a/screen.mp4'):
        assert tvideo.timestamps_path_for(path) == \
            jvideo.timestamps_path_for(path)
    with pytest.raises(ValueError):
        tvideo.timestamps_path_for('a/webcam_c.avi')
    for value in ('1', '0', 'off', 'verify', 'on'):
        monkeypatch.setenv('EVE_VIDEO_SEEK', value)
        assert tvideo._seek_mode() == jvideo._seek_mode()


def test_seek_verify_decodes_as_eve_tpu(dataset_root, monkeypatch):
    monkeypatch.setenv('EVE_VIDEO_SEEK', 'verify')
    path = os.path.join(dataset_root, 'val01', 'step008_image_test',
                        'webcam_c_eyes.mp4')
    ours = tvideo.VideoReader(path, frame_indices=[18, 21, 24],
                              backend='cv2').get_frames()
    ref = jvideo.VideoReader(path, frame_indices=[18, 21, 24],
                             backend='cv2').get_frames()
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert tvideo._seek_verified('cv2', path)


def test_missing_modules_raise_naming_them(dataset_root, configs,
                                           monkeypatch):
    _, tc = configs()
    ds = tdataset.EVESequencesBase(dataset_root, config=tc,
                                   participants_to_use=['val01'])
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='h5py'):
        ds[0]
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        tvideo._cv2()


FAKEBIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fakebin')


@pytest.mark.parametrize('seek', ['0', '1', 'verify'])
def test_ffmpeg_backend_decodes_as_eve_tpu(tmp_path, monkeypatch, seek):
    """Both readers' ffmpeg pipe through the fake ffmpeg and ffprobe of
    ``tests/fakebin`` (they decode a sidecar npz), frames and stamps equal,
    a late window seeking and duplicates included."""
    sys.path.insert(0, FAKEBIN)
    try:
        import _fake_av_impl
    finally:
        sys.path.remove(FAKEBIN)
    for mod in (tvideo, jvideo):
        monkeypatch.setattr(mod, '_FFMPEG', os.path.join(FAKEBIN, 'ffmpeg'))
        monkeypatch.setattr(mod, '_FFPROBE', os.path.join(FAKEBIN, 'ffprobe'))
    monkeypatch.setenv('EVE_VIDEO_SEEK', seek)
    path = str(tmp_path / 'webcam_c_eyes.mp4')
    frames = np.random.RandomState(0).randint(0, 256, (120, 32, 48, 3),
                                              dtype=np.uint8)
    with open(path, 'wb') as f:
        f.write(b'\x00fake-mp4')
    _fake_av_impl.write_sidecar(path, frames, 30.0)
    np.savetxt(tvideo.timestamps_path_for(path),
               np.arange(120, dtype=np.int64) * 33333333 + int(1e9),
               fmt='%d')
    for indices, size in (([0, 3, 6], None), ([90, 93, 96], (24, 16)),
                          ([99, 99, 93], None)):
        ours = tvideo.VideoReader(path, frame_indices=indices,
                                  output_size=size).get_frames()
        ref = jvideo.VideoReader(path, frame_indices=indices,
                                 output_size=size).get_frames()
        assert ours[1].dtype == np.uint8
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
