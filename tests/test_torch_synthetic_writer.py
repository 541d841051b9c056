"""The port's ``write_synthetic_dataset`` against eve_tpu's, on the CPU
(both writers need ``h5py`` and ``cv2``).

Both writers, from one seed, write an EVE tree (two participants, the
webcam at 30 fps and the basler at 60, 20 frames, 32x32 eyes) in each
appearance:

- the same files; every ``.timestamps.txt`` byte for byte;
- every ``.h5`` dataset of the same dtype and shape, within rtol/atol
  1e-6 (the gaze labels come from each package's float32 geometry, up to
  1.2e-7 rad apart);
- the frames each writer hands the encoder: the screen and full-frame
  videos equal, the eye strips within one level in at most 1e-4 of the
  values (a last-bit label difference moves an adversarial pixel on a
  rounding edge by one level);
- the decoded videos: the disc appearance's equal (0 of 120 eye videos
  differed over 30 seeds), the adversarial one's within 16 levels in at
  most 5% of the values of a video, because the lossy codec spreads a
  one-level input difference over its block and the next frames (5 of
  the 120 differed over 30 seeds, by at most 13 levels, in at most 2.6%
  of the values);
- the port's ``EVESequencesBase`` reads both trees to the same items:
  strings and int64 timestamps equal, labels within 1e-6, frames within
  the decoded videos' tolerance.
"""

import glob
import os

import cv2
import h5py
import numpy as np
import pytest

from eve_tpu.data import synthetic as jsynthetic
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.data import dataset as tdataset
from eve_tpu_torch.data import synthetic

WRITE = dict(participants=('train01', 'val01'),
             cameras=('webcam_c', 'basler'), num_frames=20, eyes_size=32,
             seed=0)
DECODED = {'disc': (0, 0.0), 'adversarial': (16, 0.05)}  # levels, share
LABEL_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope='module', params=sorted(DECODED))
def trees(request, tmp_path_factory):
    """``(appearance, port root, eve_tpu root, {relative path: frames the
    port's writer encoded}, {...: eve_tpu's})``."""
    root = tmp_path_factory.mktemp('writers_' + request.param)
    mp = pytest.MonkeyPatch()
    written = []
    for module, tag in ((synthetic, 'port'), (jsynthetic, 'eve_tpu')):
        frames, write = {}, module._write_video
        base = str(root / tag)

        def record(path, frames_uint8, fps, frames=frames, write=write,
                   base=base):
            frames[os.path.relpath(path, base)] = frames_uint8.copy()
            write(path, frames_uint8, fps)

        mp.setattr(module, '_write_video', record)
        module.write_synthetic_dataset(base, appearance=request.param,
                                       **WRITE)
        written.append(frames)
    mp.undo()
    yield (request.param, str(root / 'port'), str(root / 'eve_tpu'),
           *written)


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, '**', '*'), recursive=True) if os.path.isfile(p))


def _decode(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def _assert_frames_close(ours, theirs, levels, share, what):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype, what
    diff = np.abs(ours.astype(np.int16) - theirs)
    assert diff.max() <= levels, (what, diff.max())
    assert np.count_nonzero(diff) <= share * diff.size, (
        what, np.count_nonzero(diff) / diff.size)


def test_same_files_and_timestamps(trees):
    _, ours, theirs, _, _ = trees
    files = _files(theirs)
    assert _files(ours) == files
    assert sum(f.endswith('_eyes.mp4') for f in files) == 4
    stamps = [f for f in files if f.endswith('.timestamps.txt')]
    assert len(stamps) == 6
    for f in stamps:
        with open(os.path.join(ours, f), 'rb') as a, \
                open(os.path.join(theirs, f), 'rb') as b:
            assert a.read() == b.read(), f


def test_h5_labels_match(trees):
    _, ours, theirs, _, _ = trees
    for f in [f for f in _files(theirs) if f.endswith('.h5')]:
        with h5py.File(os.path.join(ours, f), 'r') as a, \
                h5py.File(os.path.join(theirs, f), 'r') as b:
            names = []
            b.visit(lambda n: names.append(n)
                    if isinstance(b[n], h5py.Dataset) else None)
            mine = []
            a.visit(lambda n: mine.append(n)
                    if isinstance(a[n], h5py.Dataset) else None)
            assert sorted(mine) == sorted(names) and len(names) == 30, f
            for n in names:
                x, y = a[n][()], b[n][()]
                assert x.dtype == y.dtype and x.shape == y.shape, (f, n)
                np.testing.assert_allclose(x, y, err_msg='%s %s' % (f, n),
                                           **LABEL_TOL)


def test_encoded_and_decoded_frames(trees):
    appearance, ours, theirs, encoded, encoded_ref = trees
    assert sorted(encoded) == sorted(encoded_ref) and len(encoded) == 12
    for f, frames in encoded_ref.items():
        if f.endswith('_eyes.mp4'):
            _assert_frames_close(encoded[f], frames, 1, 1e-4, f)
        else:
            np.testing.assert_array_equal(encoded[f], frames, err_msg=f)
    levels, share = DECODED[appearance]
    for f in encoded_ref:
        _assert_frames_close(_decode(os.path.join(ours, f)),
                             _decode(os.path.join(theirs, f)),
                             levels, share, f)


def test_port_reader_reads_both_trees_alike(trees, tmp_path):
    appearance, ours, theirs, _, _ = trees
    tc = tconfig.Config()
    tc.import_dict({'max_sequence_len': 6, 'assumed_frame_rate': 10,
                    'eyes_size': [32, 32], 'load_screen_content': True})
    read = [tdataset.EVESequencesBase(
        root, config=tc, participants_to_use=['train01', 'val01'],
        cameras_to_use=['webcam_c', 'basler'],
        cache_dir=str(tmp_path / tag)) for root, tag in ((ours, 'port'),
                                                         (theirs, 'ref'))]
    assert len(read[0]) == len(read[1]) > 0
    levels, share = DECODED[appearance]
    for i in range(len(read[1])):
        got, want = read[0][i], read[1][i]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            what = 'item %d %s' % (i, k)
            if isinstance(v, str):
                assert got[k] == v, what
            elif v.dtype == np.uint8:
                _assert_frames_close(got[k], v, levels, share, what)
            elif v.dtype == np.int64:
                np.testing.assert_array_equal(got[k], v, err_msg=what)
            else:
                assert got[k].dtype == v.dtype, what
                np.testing.assert_allclose(got[k], v, err_msg=what,
                                           **LABEL_TOL)
