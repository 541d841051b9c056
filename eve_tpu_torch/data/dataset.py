"""EVE dataset: HDF5 labels + video frames -> fixed-shape numpy clip dicts.

The counterpart of ``eve_tpu/data/dataset.py``, the reference's clip reader
(src/datasources/eve_sequences.py:196-335): per clip, read the selected
frames of the camera video (and of the screen video with
``load_screen_content``), slice the h5 label groups by the same indices,
derive ``head_R`` from the rotation vectors, split the eyes strip into left
and right patches, and zero-pad short clips to ``max_sequence_len`` with
zero validity. As in eve_tpu: a per-video label cache, a whole-video LRU for
``is_final_test``, truncated videos aligned to the frames they decode, and
``timestamps`` kept as the int64 nanoseconds read (the loader rebases them).

Frames stay uint8 NHWC, the layout of eve_tpu's
``tpu_on_device_preprocess=True``: the model scales them on the device
(``models.eve._to_compute`` and ``_screen_to_float``), so the host ships a
quarter of the bytes and eve_tpu's host-side float packing (``framepack``)
has no counterpart. ``h5py`` is imported where labels are read, so the
package imports on a machine without it. eve_tpu's disk frame cache
(``frame_cache_dir``) is not ported yet; the config key raises.
"""

import collections
import logging
import os
import threading

import numpy as np

from eve_tpu_torch.data.segmentation import (
    load_or_build_cache, select_sequences)
from eve_tpu_torch.data.specs import predefined_splits
from eve_tpu_torch.data.video import VideoReader

logger = logging.getLogger(__name__)

# Labels of this many videos, and the decoded frames of this many
# (video, source) pairs under ``is_final_test``, are kept.
LABEL_CACHE_SIZE = 64
FULL_VIDEO_CACHE_SIZE = 8


def _h5py():
    """h5py, imported on first use."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError('reading EVE labels needs the h5py module, which '
                          'is not installed') from exc
    return h5py


def rodrigues_np(rvec):
    """Rotation vector (3,) -> matrix (3, 3), numpy (host-side)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = np.asarray(rvec, np.float64).reshape(3) / theta
    K = np.array([[0, -k[2], k[1]],
                  [k[2], 0, -k[0]],
                  [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    return R.astype(np.float32)


def split_eye_frames(frames):
    """uint8 (N, H, W, 3) eye strip -> (left, right) uint8 patches: left is
    the strip's right half (reference eve_sequences.py:283-285)."""
    frames = np.ascontiguousarray(frames)
    half = frames.shape[2] // 2
    return (np.ascontiguousarray(frames[:, :, half:, :]),
            np.ascontiguousarray(frames[:, :, :half, :]))


class EVESequencesBase:
    """Map-style dataset over EVE clips; ``__getitem__`` -> dict of numpy.

    ``config`` is an ``eve_tpu_torch.config.Config``.
    """

    def __init__(self, dataset_path, config, participants_to_use=None,
                 cameras_to_use=None, types_of_stimuli=None,
                 stimulus_name_includes='', live_validation=False,
                 is_final_test=False, cache_dir='./segmentation_cache'):
        if types_of_stimuli is None:
            types_of_stimuli = ['image', 'video', 'wikipedia']
        if cameras_to_use is None:
            cameras_to_use = ['basler', 'webcam_l', 'webcam_c', 'webcam_r']
        if 'points' in types_of_stimuli:
            raise ValueError('the calibration points are not clips')
        if not participants_to_use:
            raise ValueError('no participants to use')
        if not (config.assumed_frame_rate < 30 and
                30 % config.assumed_frame_rate == 0):
            raise ValueError('assumed_frame_rate must divide 30 and be '
                             'below it, got %d' % config.assumed_frame_rate)
        self.config = config
        self.path = dataset_path
        self.types_of_stimuli = types_of_stimuli
        self.stimulus_name_includes = stimulus_name_includes
        self.participants_to_use = participants_to_use
        self.cameras_to_use = cameras_to_use
        self.live_validation = live_validation
        self.is_final_test = is_final_test
        self.validation_data_cache = {}
        # LRUs shared by the loader's worker threads, each under a lock.
        self.full_video_cache = collections.OrderedDict()
        self._full_video_cache_lock = threading.Lock()
        self._label_cache = collections.OrderedDict()
        self._label_cache_lock = threading.Lock()

        segmentations = load_or_build_cache(
            dataset_path, config.assumed_frame_rate, config.max_sequence_len,
            cache_dir)
        self.all_subfolders = select_sequences(
            segmentations, dataset_path, participants_to_use, cameras_to_use,
            types_of_stimuli, stimulus_name_includes,
            require_screen=config.load_screen_content)
        logger.info('Initialized dataset class for: %s (%d clips)',
                    self.path, len(self.all_subfolders))

    def __len__(self):
        return len(self.all_subfolders)

    def _camera_video_path(self, path, source):
        cfg = self.config
        base = os.path.join(path, source)
        if source == 'screen':
            return base + '.128x72.mp4', tuple(cfg.screen_size)
        if cfg.camera_frame_type == 'full':
            return base + '.mp4', None
        if cfg.camera_frame_type == 'face':
            return base + '_face.mp4', (cfg.face_size[0], cfg.face_size[1])
        if cfg.camera_frame_type == 'eyes':
            return base + '_eyes.mp4', (2 * cfg.eyes_size[0],
                                        cfg.eyes_size[1])
        raise ValueError('Unknown camera frame type: %s'
                         % cfg.camera_frame_type)

    def _load_labels_full(self, path, source):
        """Every label array of one h5 file, read once: (groups, scalars)."""
        cache_key = (path, source)
        with self._label_cache_lock:
            cached = self._label_cache.get(cache_key)
            if cached is not None:
                self._label_cache.move_to_end(cache_key)
                return cached
        h5py = _h5py()
        groups, scalars = {}, {}
        with h5py.File(os.path.join(path, source + '.h5'), 'r') as hdf:
            for k1, v1 in hdf.items():
                if isinstance(v1, h5py.Group):
                    groups[k1] = np.asarray(v1['data'])
                    groups[k1 + '_validity'] = np.asarray(v1['validity'])
                else:
                    scalars[k1] = np.asarray(v1)
        loaded = (groups, scalars)
        with self._label_cache_lock:
            self._label_cache[cache_key] = loaded
            while len(self._label_cache) > LABEL_CACHE_SIZE:
                self._label_cache.popitem(last=False)
        return loaded

    def _whole_video(self, video_path, output_size, cache_key):
        """Every frame of one video, decoded once (``is_final_test``)."""
        with self._full_video_cache_lock:
            cached = self.full_video_cache.get(cache_key)
            if cached is not None:
                self.full_video_cache.move_to_end(cache_key)
                return cached
        decoded = VideoReader(video_path, output_size=output_size).get_frames()
        with self._full_video_cache_lock:
            self.full_video_cache[cache_key] = decoded
            while len(self.full_video_cache) > FULL_VIDEO_CACHE_SIZE:
                self.full_video_cache.popitem(last=False)
        return decoded

    def load_all_from_source(self, path, source, selected_indices):
        cfg = self.config
        subentry = {}

        scalar_keys = ()
        if source != 'screen':
            groups, scalars = self._load_labels_full(path, source)
            scalar_keys = tuple(scalars)
            index = np.asarray(selected_indices)
            for k1, full in groups.items():
                subentry[k1] = full[index]  # a copy, never a cached view
            for k1, value in scalars.items():
                subentry[k1] = np.repeat(
                    np.reshape(value, (1, *value.shape)),
                    repeats=cfg.max_sequence_len, axis=0)
            if 'head_rvec' in subentry:
                subentry['head_R'] = np.stack([
                    rodrigues_np(rvec) for rvec in subentry['head_rvec']])

        if cfg.load_full_frame_for_visualization and source == 'screen':
            _, full_frames = VideoReader(
                os.path.join(path, source + '.mp4'),
                frame_indices=selected_indices).get_frames()
            subentry['full_frame'] = full_frames

        video_path, output_size = self._camera_video_path(path, source)
        if self.is_final_test:
            timestamps, frames = self._whole_video(video_path, output_size,
                                                   (path, source))
            # A truncated video decodes fewer frames than its labels claim:
            # the alignment and padding below zero the missing tail.
            in_range = [i for i in selected_indices if i < frames.shape[0]]
            timestamps = timestamps[in_range]
            frames = frames[in_range]
        else:
            timestamps, frames = VideoReader(
                video_path, frame_indices=selected_indices,
                output_size=output_size).get_frames()

        subentry['timestamps'] = np.asarray(timestamps, np.int64)
        if source != 'screen' and cfg.camera_frame_type == 'eyes':
            left, right = split_eye_frames(frames)
            subentry['left_eye_patch'] = left
            subentry['right_eye_patch'] = right
        else:
            subentry['frame'] = np.ascontiguousarray(frames)

        # Align every per-frame array to the decoded length, so the padding
        # below also zeroes the validity of a truncated video's tail.
        # Scalar-derived labels (camera matrices, px/mm) are constants,
        # kept at every row as the reference keeps them.
        n_frames = (subentry['left_eye_patch'].shape[0]
                    if 'left_eye_patch' in subentry
                    else subentry['frame'].shape[0])
        for key, value in subentry.items():
            if key not in scalar_keys and value.shape[0] > n_frames:
                subentry[key] = value[:n_frames]

        # Zero-pad short clips (zero validity for padded frames).
        for key, value in subentry.items():
            if value.shape[0] < cfg.max_sequence_len:
                pad_len = cfg.max_sequence_len - value.shape[0]
                pad_width = [(0, pad_len)] + [(0, 0)] * (value.ndim - 1)
                subentry[key] = np.pad(
                    value, pad_width, mode='constant',
                    constant_values=(False if value.dtype == np.bool_
                                     else 0))
        return subentry

    def __getitem__(self, idx):
        spec = self.all_subfolders[idx]
        path = spec['full_path']
        source = spec['camera_name']

        if self.live_validation:
            cache_key = '%s/%s/%s' % (path, source, tuple(spec['indices']))
            if cache_key in self.validation_data_cache:
                return self.validation_data_cache[cache_key]

        entry = self.load_all_from_source(path, source, spec['indices'])
        if self.config.load_screen_content:
            sub = self.load_all_from_source(path, 'screen',
                                            spec['screen_indices'])
            for k, v in sub.items():
                entry['screen_%s' % k] = v

        entry['participant'] = spec['participant']
        entry['subfolder'] = spec['subfolder']
        entry['camera'] = spec['camera_name']

        if self.live_validation:
            self.validation_data_cache[cache_key] = entry
        return entry


class EVESequences_train(EVESequencesBase):
    def __init__(self, dataset_path, **kwargs):
        super().__init__(dataset_path,
                         participants_to_use=predefined_splits['train'],
                         **kwargs)


class EVESequences_val(EVESequencesBase):
    def __init__(self, dataset_path, **kwargs):
        super().__init__(dataset_path,
                         participants_to_use=predefined_splits['val'],
                         **kwargs)


class EVESequences_test(EVESequencesBase):
    def __init__(self, dataset_path, **kwargs):
        super().__init__(dataset_path,
                         participants_to_use=predefined_splits['test'],
                         **kwargs)
