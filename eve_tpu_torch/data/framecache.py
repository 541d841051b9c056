"""Decode-once disk cache of the training windows' frames.

The port's copy of ``eve_tpu/data/framecache.py``, with the same keys and
layout, so eve_tpu and the port share one cache directory. The reader
decodes every training window from its mp4 in every epoch; decoding is
deterministic per (video, window), so each decoded window is written once,
uint8 frames exactly as ``VideoReader`` returns them (resized, RGB) plus
the int64 timestamps, and later epochs read it from disk:

  * **Keying**: SHA-1 of (absolute video path, mtime_ns, file size,
    output size, the exact frame-index tuple, cache format version 1). A
    re-encoded or replaced video changes mtime or size and misses.
  * **Layout**: ``<dir>/<k[:2]>/<k>.npz`` holding ``timestamps`` and
    ``frames``, one file a window.
  * **Atomicity and integrity**: writes go to a temporary file in the same
    directory, then ``os.replace`` (concurrent writers: the last one
    wins); a corrupt or truncated file fails ``np.load`` and is treated as
    a miss, deleted, and rewritten.
  * **Budget**: ``frame_cache_gb`` bounds the directory, checked when the
    cache is attached and every 256 writes: the least recently written
    files are evicted down to 90% of the budget.

Keys are content hashes, so the cache composes with exact resume
(``fast_forward`` replays the same windows and hits).
"""

import hashlib
import logging
import os
import tempfile
import threading

import numpy as np

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1
_EVICT_CHECK_EVERY = 256


class FrameDiskCache:
    """Content-keyed uint8 window cache under one directory."""

    def __init__(self, root, budget_gb=20.0):
        self.root = os.path.abspath(root)
        self.budget_bytes = int(float(budget_gb) * (1 << 30))
        os.makedirs(self.root, exist_ok=True)
        self._puts = 0
        self._lock = threading.Lock()
        self._enforce_budget()

    # -- keying --------------------------------------------------------

    def key(self, video_path, frame_indices, output_size):
        try:
            st = os.stat(video_path)
        except OSError:
            return None
        h = hashlib.sha1()
        h.update(repr((os.path.abspath(video_path), st.st_mtime_ns,
                       st.st_size, tuple(output_size or ()),
                       tuple(int(i) for i in frame_indices),
                       _FORMAT_VERSION)).encode())
        return h.hexdigest()

    def _path(self, key):
        return os.path.join(self.root, key[:2], key + '.npz')

    # -- read/write ----------------------------------------------------

    def get(self, key):
        """-> (timestamps int64 (N,), frames uint8 (N, H, W, 3)) or None."""
        if key is None:
            return None
        path = self._path(key)
        try:
            with np.load(path) as z:
                return z['timestamps'], z['frames']
        except FileNotFoundError:
            return None
        except Exception:  # corrupt/truncated: miss + delete
            logger.warning('frame cache: dropping unreadable entry %s', path)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    def put(self, key, timestamps, frames):
        if key is None:
            return
        path = self._path(key)
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                np.savez(f, timestamps=np.asarray(timestamps, np.int64),
                         frames=np.ascontiguousarray(frames))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self._puts += 1
            check = self._puts % _EVICT_CHECK_EVERY == 0
        if check:
            self._enforce_budget()

    # -- budget --------------------------------------------------------

    def _enforce_budget(self):
        try:
            entries = []
            total = 0
            for sub in os.scandir(self.root):
                if not sub.is_dir():
                    continue
                for e in os.scandir(sub.path):
                    if not e.name.endswith('.npz'):
                        continue
                    st = e.stat()
                    entries.append((st.st_mtime_ns, st.st_size, e.path))
                    total += st.st_size
            if total <= self.budget_bytes:
                return
            entries.sort()
            target = int(self.budget_bytes * 0.9)
            freed = 0
            for _mt, size, path in entries:
                if total - freed <= target:
                    break
                try:
                    os.unlink(path)
                    freed += size
                except OSError:
                    pass
            logger.info('frame cache: evicted %.1f MB (budget %.1f GB)',
                        freed / 2**20, self.budget_bytes / 2**30)
        except OSError as e:  # never fail the training loop on cache IO
            logger.warning('frame cache: budget scan failed: %s', e)
