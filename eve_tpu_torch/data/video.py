"""Frame-exact video decode on the host.

A copy of ``eve_tpu/data/video.py``, which keeps the reference's semantics
(src/datasources/common.py:50-172): the synchronous ``VideoReader`` and the
streaming ``AsyncVideoReader``, each with two backends:

* ``ffmpeg``: a raw-RGB24 subprocess pipe (used when the binary exists),
  with the reference's filter graph, ``select='eq(n,i)+...'`` frame picking
  and ``scale=w:h`` resizing (``ffmpeg_pipe_cmd``);
* ``cv2``: OpenCV ``VideoCapture`` decode with exact frame-index picking,
  used when no ffmpeg binary is available. Resize is bilinear (ffmpeg's
  default scaler is bicubic).

Random-access windows seek to the first wanted frame: ``CAP_PROP_POS_FRAMES``
plus decode-only ``grab()`` across gaps on cv2, an input-side ``-ss`` at the
midpoint before the first wanted frame on ffmpeg, gated on an ffprobe
constant-frame-rate check. ``EVE_VIDEO_SEEK``: '1' (default), '0' (the
sequential scan on both backends) or 'verify' (the first seek-decode of
each video is cross-checked against the scan and raises on a mismatch).

Timestamps come from the sibling ``*.timestamps.txt`` files with the
reference's suffix mapping. ``cv2`` is imported where a frame is decoded
through it, so the package imports on a machine without OpenCV.
"""

import collections
import os
import shutil
import subprocess
import threading

import numpy as np

_FFMPEG = shutil.which('ffmpeg')
_FFPROBE = shutil.which('ffprobe')


def _cv2():
    """OpenCV, imported on first use."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError('decoding EVE videos without an ffmpeg binary '
                          'needs OpenCV (the cv2 module), which is not '
                          'installed') from exc
    return cv2


def _seek_mode():
    """EVE_VIDEO_SEEK: '1'/'on' (default) | '0'/'off' | 'verify'.

    'verify': the first seek-decode of each video is cross-checked
    against the sequential scan (byte-identical frames) and raises
    RuntimeError on mismatch — run it over a sample of a new dataset /
    codec before trusting 'on'. Seek exactness is pinned by tests for
    this OpenCV build on inter-coded mp4v; H.264 streams with B-frames
    on other builds are the case 'verify' exists for.
    """
    value = os.environ.get('EVE_VIDEO_SEEK', '1').lower()
    if value in ('0', 'off', 'no'):
        return 'off'
    if value == 'verify':
        return 'verify'
    return 'on'


def _seek_enabled():
    return _seek_mode() != 'off'


# (backend, path) pairs whose seek-decode matched the sequential scan
# under 'verify'. Keyed per backend: cv2 frame-number seek and ffmpeg
# input -ss are unrelated mechanisms that must be validated separately.
_VERIFIED_SEEK_PATHS = set()
_VERIFIED_SEEK_LOCK = threading.Lock()


def _seek_verified(backend, path):
    with _VERIFIED_SEEK_LOCK:
        return (backend, path) in _VERIFIED_SEEK_PATHS


def _mark_seek_verified(backend, path):
    with _VERIFIED_SEEK_LOCK:
        if len(_VERIFIED_SEEK_PATHS) > 4096:
            _VERIFIED_SEEK_PATHS.clear()
        _VERIFIED_SEEK_PATHS.add((backend, path))


# np.loadtxt of the timestamps file profiled at ~5% of windowed-item cost
# (every window re-parsed the same text file), and an ffprobe fps probe
# would be a per-window process spawn. Both are per-video constants:
# true LRUs keyed by path with the mtime in the value (a rewritten file
# replaces its entry instead of leaving a dead one), lock-guarded because
# loader workers are threads.
_TS_CACHE = collections.OrderedDict()
_TS_CACHE_LOCK = threading.Lock()
_TS_CACHE_MAX = 1024
_FPS_CACHE = collections.OrderedDict()
_FPS_CACHE_LOCK = threading.Lock()


def _lru_get(cache, lock, path, mtime):
    with lock:
        hit = cache.get(path)
        if hit is not None and hit[0] == mtime:
            cache.move_to_end(path)
            return hit[1]
    return None


def _lru_put(cache, lock, path, mtime, value, max_entries=_TS_CACHE_MAX):
    with lock:
        cache[path] = (mtime, value)
        cache.move_to_end(path)
        while len(cache) > max_entries:
            cache.popitem(last=False)


def _probe_cfr_fps(video_path):
    """ffprobe the stream's frame rate; a float only for CFR streams.

    Returns None (no seek) when ffprobe is unavailable, the rate is
    malformed, or ``avg_frame_rate`` disagrees with ``r_frame_rate`` —
    the standard container signature of a variable-frame-rate stream,
    where frame-number -> time conversion (and hence input seeking) is
    not exact.
    """
    if not _FFPROBE:
        return None
    try:
        out = subprocess.check_output([
            _FFPROBE, '-v', 'quiet', '-select_streams', 'v:0',
            '-show_entries', 'stream=avg_frame_rate,r_frame_rate',
            '-of', 'csv=p=0', video_path]).decode().strip()
    except (subprocess.CalledProcessError, OSError):
        return None
    parts = out.replace('\n', ',').split(',')
    rates = []
    for token in parts[:2]:
        try:
            num, _, den = token.partition('/')
            den = den or '1'
            if float(den) == 0:
                return None
            rates.append(float(num) / float(den))
        except ValueError:
            return None
    if len(rates) != 2 or rates[0] <= 0 or \
            abs(rates[0] - rates[1]) > 1e-6:
        return None
    return rates[0]


def _probe_cfr_fps_cached(video_path):
    mtime = os.path.getmtime(video_path)
    hit = _lru_get(_FPS_CACHE, _FPS_CACHE_LOCK, video_path, mtime)
    if hit is not None:
        return hit[0]
    fps = _probe_cfr_fps(video_path)
    # Wrap in a tuple so a cached None ("probed: not CFR") is
    # distinguishable from a cache miss.
    _lru_put(_FPS_CACHE, _FPS_CACHE_LOCK, video_path, mtime, (fps,))
    return fps


def ffmpeg_pipe_cmd(video_path, frame_indices, output_size, fps,
                    seek=True):
    """Build the ffmpeg raw-RGB24 pipe command, with optional fast seek.

    A pure function. When ``seek`` is on, ``fps`` is known (CFR, see
    ``_probe_cfr_fps``) and the first wanted frame is late enough to pay
    for a seek, an input-side ``-ss`` is placed BEFORE ``-i``: ffmpeg
    seeks to the keyframe at-or-before the target and decode-discards up
    to it exactly (frame-accurate input seeking, ffmpeg >= 2.1). The seek
    target is the MIDPOINT between frames ``first-1`` and ``first`` so
    sub-millisecond pts jitter cannot skip the target frame, and the
    ``select=eq(n,i)`` indices are rebased by ``first`` because output
    frame numbering restarts at the seek point.
    """
    pre_input = []
    rebase = 0
    if frame_indices and seek and fps:
        first = min(frame_indices)
        # A seek that skips <2s of decode is within ffmpeg startup noise.
        if first / fps > 2.0:
            pre_input = ['-ss', '%.6f' % ((first - 0.5) / fps)]
            rebase = first
    vf = []
    if frame_indices is not None:
        sel = '+'.join('eq(n,%d)' % (i - rebase) for i in frame_indices)
        vf.append("select='%s'" % sel)
    if output_size is not None:
        vf.append('scale=%d:%d' % (output_size[0], output_size[1]))
    cmd = [_FFMPEG, '-vsync', '0'] + pre_input + ['-i', video_path]
    if vf:
        cmd += ['-vf', ','.join(vf)]
    cmd += ['-f', 'rawvideo', '-pix_fmt', 'rgb24',
            '-loglevel', 'quiet', 'pipe:']
    return cmd


def _load_timestamps_cached(path):
    mtime = os.path.getmtime(path)
    hit = _lru_get(_TS_CACHE, _TS_CACHE_LOCK, path, mtime)
    if hit is not None:
        return hit
    ts = np.loadtxt(path).astype(np.int64)
    if ts.ndim == 0:
        ts = ts[None]
    ts.setflags(write=False)
    _lru_put(_TS_CACHE, _TS_CACHE_LOCK, path, mtime, ts)
    return ts


def timestamps_path_for(video_path):
    for suffix, repl in (('_eyes.mp4', '.timestamps.txt'),
                         ('_face.mp4', '.timestamps.txt'),
                         ('.128x72.mp4', '.timestamps.txt'),
                         ('.mp4', '.timestamps.txt')):
        if video_path.endswith(suffix):
            return video_path[:-len(suffix)] + repl
    raise ValueError('Unrecognized video path: %s' % video_path)


class VideoReader:
    """Synchronous frame-exact reader; see module docstring."""

    def __init__(self, video_path, frame_indices=None, output_size=None,
                 backend=None):
        self.video_path = video_path
        self.frame_indices = (None if frame_indices is None
                              else list(frame_indices))
        self.output_size = output_size  # (width, height)
        if backend is None:
            backend = 'ffmpeg' if _FFMPEG else 'cv2'
        self.backend = backend
        self.timestamps_path = timestamps_path_for(video_path)
        for path in (self.video_path, self.timestamps_path):
            if not os.path.isfile(path):
                raise FileNotFoundError(path)

    def _load_timestamps(self):
        return _load_timestamps_cached(self.timestamps_path)

    def get_frames(self):
        """Returns (timestamps int64 (N,), frames uint8 (N, H, W, 3) RGB)."""
        timestamps = self._load_timestamps()
        if self.frame_indices is not None:
            timestamps = timestamps[self.frame_indices]
        if self.backend == 'ffmpeg':
            frames = self._decode_ffmpeg()
        else:
            frames = self._decode_cv2_checked()
        return timestamps, frames

    def _empty_frames(self):
        """(0, H, W, 3) with the REAL output dims: a zero-frame decode must
        keep H/W so the dataset's zero-padding produces correctly-shaped
        (just invalid) clips that still stack into a batch."""
        if self.output_size is not None:
            width, height = self.output_size
        else:
            width, height = self._probe_size()
        return np.zeros((0, height, width, 3), np.uint8)

    # -- cv2 backend --------------------------------------------------

    def _cv2_wanted_frames(self, use_seek):
        """Yield (index, RGB frame) for each wanted frame, in stream order.

        The cv2 decode loop: fast seek to the first wanted frame,
        ``grab()`` (decode-only) across gaps, BGR->RGB + resize only for
        wanted frames, early stop past the last wanted index or at EOF.
        """
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.video_path)
        if not cap.isOpened():
            raise OSError('cv2 cannot open %s' % self.video_path)
        wanted = (None if self.frame_indices is None
                  else set(self.frame_indices))
        index = 0
        last_wanted = None
        if wanted is not None:
            first_wanted = min(wanted)
            last_wanted = max(wanted)
            if first_wanted > 0 and use_seek:
                if cap.set(cv2.CAP_PROP_POS_FRAMES, first_wanted):
                    index = first_wanted
        try:
            while True:
                if wanted is not None and index not in wanted:
                    # Decode-only skip: no BGR->RGB convert, no frame copy.
                    if not cap.grab():
                        return
                    index += 1
                    if index > last_wanted:
                        return
                    continue
                ok, frame = cap.read()
                if not ok:
                    return
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if self.output_size is not None:
                    frame = cv2.resize(frame, tuple(self.output_size),
                                       interpolation=cv2.INTER_LINEAR)
                yield index, frame
                index += 1
                if last_wanted is not None and index > last_wanted:
                    return
        finally:
            cap.release()

    def _decode_cv2_checked(self):
        """Dispatch on the EVE_VIDEO_SEEK mode (see ``_seek_mode``)."""
        mode = _seek_mode()
        if mode == 'off':
            return self._decode_cv2(use_seek=False)
        if mode == 'verify' and self.frame_indices and \
                min(self.frame_indices) > 0 and \
                not _seek_verified('cv2', self.video_path):
            seeked = self._decode_cv2(use_seek=True)
            scanned = self._decode_cv2(use_seek=False)
            if seeked.shape != scanned.shape or \
                    not np.array_equal(seeked, scanned):
                raise RuntimeError(
                    'EVE_VIDEO_SEEK=verify: seek-decode of %s does not '
                    'match the sequential scan — this codec/OpenCV '
                    'build has non-exact frame seeking; run with '
                    'EVE_VIDEO_SEEK=0' % self.video_path)
            _mark_seek_verified('cv2', self.video_path)
            return seeked
        return self._decode_cv2(use_seek=True)

    def _decode_cv2(self, use_seek=True):
        if self.frame_indices is not None and len(self.frame_indices) == 0:
            return self._empty_frames()
        if self.frame_indices is None:
            sequential = [f for _, f in self._cv2_wanted_frames(use_seek)]
            return (np.stack(sequential) if sequential
                    else self._empty_frames())
        frames_by_index = dict(self._cv2_wanted_frames(use_seek))
        # Frame order follows the requested index list (duplicates allowed).
        got = [frames_by_index[i] for i in self.frame_indices
               if i in frames_by_index]
        return np.stack(got) if got else self._empty_frames()

    # -- ffmpeg backend ------------------------------------------------

    def _probe_size(self):
        if _FFPROBE:
            out = subprocess.check_output([
                _FFPROBE, '-v', 'quiet', '-select_streams', 'v:0',
                '-show_entries', 'stream=width,height', '-of', 'csv=p=0',
                self.video_path]).decode().strip().split(',')
            return int(out[0]), int(out[1])
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.video_path)
        size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        cap.release()
        return size

    def _decode_ffmpeg(self):
        """Seek-mode dispatch for ffmpeg, mirroring ``_decode_cv2_checked``:
        'verify' cross-checks the first seek-decode of each video against
        the no-seek pipe (input ``-ss`` exactness is container-dependent),
        then trusts seeks for that video."""
        mode = _seek_mode()
        if mode == 'off':
            return self._decode_ffmpeg_once(seek=False)
        if mode == 'verify' and self.frame_indices and \
                min(self.frame_indices) > 0 and \
                not _seek_verified('ffmpeg', self.video_path):
            seeked = self._decode_ffmpeg_once(seek=True)
            scanned = self._decode_ffmpeg_once(seek=False)
            if seeked.shape != scanned.shape or \
                    not np.array_equal(seeked, scanned):
                raise RuntimeError(
                    'EVE_VIDEO_SEEK=verify: ffmpeg seek-decode of %s does '
                    'not match the sequential pipe — input -ss is not '
                    'frame-exact for this container; run with '
                    'EVE_VIDEO_SEEK=0' % self.video_path)
            _mark_seek_verified('ffmpeg', self.video_path)
            return seeked
        return self._decode_ffmpeg_once(seek=True)

    def _decode_ffmpeg_once(self, seek):
        if self.frame_indices is not None and len(self.frame_indices) == 0:
            return self._empty_frames()
        if self.output_size is not None:
            width, height = self.output_size
        else:
            width, height = self._probe_size()
        # The select filter emits each matching frame ONCE, in stream
        # order; decode sorted-unique indices and remap below so the
        # public contract (request order, duplicates allowed) holds for
        # this backend exactly as it does for cv2.
        stream_order = (None if self.frame_indices is None
                        else sorted(set(self.frame_indices)))
        fps = (_probe_cfr_fps_cached(self.video_path)
               if seek and stream_order and stream_order[0] > 0 else None)
        cmd = ffmpeg_pipe_cmd(self.video_path, stream_order,
                              self.output_size, fps, seek=seek)
        raw = subprocess.run(cmd, stdout=subprocess.PIPE,
                             check=True).stdout
        frames = np.frombuffer(raw, np.uint8).reshape(
            -1, height, width, 3)
        if stream_order is None:
            return frames
        # A truncated stream yields a prefix of stream_order's frames.
        position = {f: i for i, f in
                    enumerate(stream_order[:frames.shape[0]])}
        got = [frames[position[i]] for i in self.frame_indices
               if i in position]
        return np.stack(got) if got else self._empty_frames()


class AsyncVideoReader:
    """Streaming decode iterator yielding (timestamp, frame) pairs.

    Mirrors the reference VideoReader's async-iterator mode
    (src/datasources/common.py:141-172): an ffmpeg raw-RGB24 subprocess
    pipe consumed one frame at a time — bounded memory for unbounded
    live-stream videos — with the same ``select=eq(n,i)`` frame picking and
    ``scale`` filter graph as the sync path, plus a cv2 fallback when no
    ffmpeg binary exists. Usable as a context manager (the reference's
    ``__enter__``/``__exit__``); iteration also cleans up on exhaustion.
    """

    def __init__(self, video_path, output_size=None, frame_indices=None,
                 backend=None):
        if frame_indices is not None:
            idx = list(frame_indices)
            # Streaming yields frames in stream order, so a request list
            # with duplicates or out-of-order indices cannot be honored
            # (the sync VideoReader supports those; use it instead).
            # Silently set-collapsing would truncate AND mispair
            # (timestamp, frame) tuples.
            if any(b <= a for a, b in zip(idx, idx[1:])):
                raise ValueError(
                    'AsyncVideoReader needs strictly increasing '
                    'frame_indices (got %r); use VideoReader for '
                    'duplicate/reordered index lists' % (idx,))
        self.reader = VideoReader(video_path, frame_indices=frame_indices,
                                  output_size=output_size, backend=backend)
        self.output_size = output_size
        self.frame_indices = self.reader.frame_indices
        self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def close(self):
        if self._proc is not None:
            self._proc.stdout.close()
            self._proc.wait()
            self._proc = None

    def __iter__(self):
        timestamps = self.reader._load_timestamps()
        if self.frame_indices is not None:
            selected_ts = [timestamps[i] for i in self.frame_indices]
        else:
            selected_ts = list(timestamps)
        if self.reader.backend == 'ffmpeg':
            yield from self._iter_ffmpeg(selected_ts)
        else:
            yield from self._iter_cv2(selected_ts)

    def _seek_allowed(self, backend):
        """Streaming iterators cannot cross-check themselves; under
        'verify' they seek only for videos the sync reader already
        verified for this backend, else they scan."""
        mode = _seek_mode()
        if mode == 'verify':
            return _seek_verified(backend, self.reader.video_path)
        return mode == 'on'

    def _iter_ffmpeg(self, selected_ts):
        if self.output_size is not None:
            width, height = self.output_size
        else:
            width, height = self.reader._probe_size()
        seek = self._seek_allowed('ffmpeg')
        fps = (_probe_cfr_fps_cached(self.reader.video_path)
               if seek and self.frame_indices
               and min(self.frame_indices) > 0 else None)
        cmd = ffmpeg_pipe_cmd(self.reader.video_path, self.frame_indices,
                              self.output_size, fps, seek=seek)
        frame_bytes = width * height * 3
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        try:
            for ts in selected_ts:
                raw = self._proc.stdout.read(frame_bytes)
                if len(raw) < frame_bytes:
                    return
                yield ts, np.frombuffer(raw, np.uint8).reshape(
                    height, width, 3)
        finally:
            self.close()

    def _iter_cv2(self, selected_ts):
        # Same shared decode loop as the sync reader; frame_indices are
        # strictly increasing (enforced in __init__), so stream order IS
        # request order and pairs off against selected_ts directly.
        emitted = 0
        for _, frame in self.reader._cv2_wanted_frames(
                use_seek=self._seek_allowed('cv2')):
            if emitted >= len(selected_ts):
                return
            yield selected_ts[emitted], frame
            emitted += 1
