"""The port's streaming ``AsyncVideoReader`` against eve_tpu's, on the CPU.

Both readers pick the same backend (``ffmpeg`` when its binary is
found, else OpenCV's cv2, the path run where no ffmpeg is installed) and
are compared on it: on a synthetic EVE tree (the port's writer), for
every frame, a strictly increasing subset and an ``output_size``, under each
``EVE_VIDEO_SEEK`` mode, the port yields the same ``(timestamp, frame)``
pairs as eve_tpu, bitwise, which are also the synchronous
``VideoReader``'s. Indices that do not strictly increase raise eve_tpu's
``ValueError``. The ffmpeg pipe path runs against a stand-in process that
writes raw RGB frames (the command ``ffmpeg_pipe_cmd`` builds is held to
eve_tpu's by ``tests/test_torch_data_reader.py``): the same pairs as
eve_tpu's, and leaving the loop early closes the pipe and reaps the
process, as running out does.
"""

import os
import sys

import numpy as np
import pytest

from eve_tpu.data import video as jvideo
from eve_tpu_torch.data import synthetic
from eve_tpu_torch.data import video as tvideo

CASES = {
    'all frames': (None, None),
    'subset': ([1, 4, 5, 9], None),
    'subset resized': ([2, 3, 10], (64, 32)),
    'resized': (None, (48, 24)),
}


@pytest.fixture(scope='module')
def eyes_video(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('async_video'))
    synthetic.write_synthetic_dataset(root, participants=('val01',),
                                      num_frames=12, eyes_size=32)
    return os.path.join(root, 'val01', 'step008_image_test',
                        'webcam_c_eyes.mp4')


def _pairs(reader):
    with reader:
        return [(int(ts), frame.copy()) for ts, frame in reader]


@pytest.mark.parametrize('seek', ['1', '0', 'verify'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_pairs_are_eve_tpus(eyes_video, case, seek, monkeypatch):
    monkeypatch.setenv('EVE_VIDEO_SEEK', seek)
    indices, size = CASES[case]
    ours = _pairs(tvideo.AsyncVideoReader(
        eyes_video, output_size=size, frame_indices=indices))
    theirs = _pairs(jvideo.AsyncVideoReader(
        eyes_video, output_size=size, frame_indices=indices))
    assert len(ours) == len(theirs) == (12 if indices is None
                                        else len(indices))
    for (a, x), (b, y) in zip(ours, theirs):
        assert a == b
        np.testing.assert_array_equal(x, y)
    stamps, frames = tvideo.VideoReader(
        eyes_video, frame_indices=indices, output_size=size).get_frames()
    assert [ts for ts, _ in ours] == stamps.tolist()
    np.testing.assert_array_equal(np.stack([f for _, f in ours]), frames)
    if size is not None:
        assert frames.shape[1:] == (size[1], size[0], 3)


@pytest.mark.parametrize('indices', [[3, 3], [5, 2], [0, 4, 1]],
                         ids=str)
def test_indices_must_increase(eyes_video, indices):
    with pytest.raises(ValueError) as theirs:
        jvideo.AsyncVideoReader(eyes_video, frame_indices=indices)
    with pytest.raises(ValueError) as ours:
        tvideo.AsyncVideoReader(eyes_video, frame_indices=indices)
    assert str(ours.value) == str(theirs.value)


SHAPE = (12, 64, 128, 3)  # 295 kB: more than a pipe's buffer holds


def _frames():
    return np.random.RandomState(0).randint(0, 256, SHAPE).astype(np.uint8)


def _fake_ffmpeg(module, monkeypatch, log):
    """``module``'s ffmpeg pipe replaced by a process that records its pid
    and writes ``_frames()`` as raw RGB24."""
    code = ('import os, sys, numpy as np\n'
            'open(%r, "w").write(str(os.getpid()))\n'
            'frames = np.random.RandomState(0).randint(0, 256, %r)\n'
            'sys.stdout.buffer.write(frames.astype(np.uint8).tobytes())\n'
            % (log, SHAPE))
    monkeypatch.setattr(module, 'ffmpeg_pipe_cmd',
                        lambda *args, **kw: [sys.executable, '-c', code])


def test_ffmpeg_pipe_pairs_and_early_exit(eyes_video, tmp_path,
                                          monkeypatch):
    frames = _frames()
    size = (SHAPE[2], SHAPE[1])
    log = str(tmp_path / 'pid')
    got = {}
    for module in (tvideo, jvideo):
        _fake_ffmpeg(module, monkeypatch, log)
        got[module] = _pairs(module.AsyncVideoReader(
            eyes_video, output_size=size, backend='ffmpeg'))
    ours, theirs = got[tvideo], got[jvideo]
    assert len(ours) == len(theirs) == 12
    for (a, x), (b, y), want in zip(ours, theirs, frames):
        assert a == b
        np.testing.assert_array_equal(x, want)
        np.testing.assert_array_equal(y, want)

    # Out after two frames, with the writer blocked on the full pipe.
    reader = tvideo.AsyncVideoReader(eyes_video, output_size=size,
                                     backend='ffmpeg')
    with reader:
        for i, (_, frame) in enumerate(reader):
            assert reader._proc is not None
            if i == 1:
                break
    assert reader._proc is None
    with open(log) as f:
        pid = int(f.read())
    # The child was reaped: waiting for it again finds no such child.
    with pytest.raises(ChildProcessError):
        os.waitpid(pid, 0)
