"""Sequence segmentation cache and selection.

A copy of ``eve_tpu/data/segmentation.py``, with the same cache file name
and pickle format, so either package reads the cache the other wrote.

Reference behavior (src/datasources/eve_sequences.py:83-191): walk
participant/stimulus directories, read per-source ``*.timestamps.txt``, cut
each video into windows of ``max_sequence_len`` frames at
``assumed_frame_rate`` Hz by skipping every ``fps/assumed_frame_rate``-th
frame, pickle the index lists to
``./segmentation_cache/<N>Hz_seqlen<L>.pkl``, then filter by
participant/camera/stimulus into a flat clip list (one entry per
``__getitem__`` item).
"""

import logging
import os
import pickle

import numpy as np

from eve_tpu_torch.data.specs import (
    SOURCES, source_to_fps, stimulus_type_from_folder_name)

logger = logging.getLogger(__name__)


def cache_path(cache_dir, assumed_frame_rate, max_sequence_len):
    return os.path.join(cache_dir, '%dHz_seqlen%d.pkl'
                        % (assumed_frame_rate, max_sequence_len))


def build_segmentation_cache(dataset_path, assumed_frame_rate,
                             max_sequence_len,
                             cache_dir='./segmentation_cache'):
    """Cut every video into fixed windows; returns + pickles the index map."""
    all_folders = sorted(
        d for d in os.listdir(dataset_path)
        if os.path.isdir(os.path.join(dataset_path, d)))
    output = {}
    for folder_name in all_folders:
        participant_path = os.path.join(dataset_path, folder_name)
        output[folder_name] = {}
        subfolders = sorted(
            p for p in os.listdir(participant_path)
            if os.path.isdir(os.path.join(participant_path, p))
            and p.startswith('step')
            and 'eye_tracker_calibration' not in p)
        for subfolder in subfolders:
            subfolder_path = os.path.join(participant_path, subfolder)
            output[folder_name][subfolder] = {}
            for source in SOURCES:
                ts_path = os.path.join(subfolder_path,
                                       source + '.timestamps.txt')
                if not os.path.isfile(ts_path):
                    continue
                available = np.loadtxt(ts_path)
                num_available = (1 if available.ndim == 0
                                 else len(available))
                fps = source_to_fps[source]
                target_len_s = max_sequence_len / assumed_frame_rate
                window = fps * target_len_s
                if not float(window).is_integer():
                    raise ValueError(
                        '%d frames of %s at %g fps are no whole number of '
                        'frames at %d fps' % (max_sequence_len, source,
                                              assumed_frame_rate, fps))
                window = int(window)
                interval = int(fps / assumed_frame_rate)
                segments = []
                start = 0
                while start < num_available:
                    end = min(start + window, num_available)
                    segments.append(list(range(start, end, interval)))
                    start += window
                if segments:
                    output[folder_name][subfolder][source] = segments

    path = cache_path(cache_dir, assumed_frame_rate, max_sequence_len)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(output, f)
    logger.info('> Stored indices of sequences to: %s', path)
    return output


def load_or_build_cache(dataset_path, assumed_frame_rate, max_sequence_len,
                        cache_dir='./segmentation_cache'):
    path = cache_path(cache_dir, assumed_frame_rate, max_sequence_len)
    if os.path.isfile(path):
        with open(path, 'rb') as f:
            return pickle.load(f)
    return build_segmentation_cache(dataset_path, assumed_frame_rate,
                                    max_sequence_len, cache_dir)


def select_sequences(segmentations, dataset_path, participants_to_use,
                     cameras_to_use, types_of_stimuli,
                     stimulus_name_includes='', require_screen=False):
    """Filter the cache into a flat clip list (reference :163-191).

    ``require_screen`` drops folders with no screen stream at all
    (loading such a clip with ``load_screen_content`` on would otherwise
    fail at decode time with an empty frame-index list).
    """
    all_subfolders = []
    for participant_name, participant_data in segmentations.items():
        if participant_name not in participants_to_use:
            continue
        for stimulus_name, stimulus_segments in participant_data.items():
            stype = stimulus_type_from_folder_name(stimulus_name)
            if stype not in types_of_stimuli:
                continue
            if stimulus_name_includes and \
                    stimulus_name_includes not in stimulus_name:
                continue
            screen_segments = stimulus_segments.get('screen', [])
            if require_screen and not screen_segments:
                logger.warning(
                    '%s/%s: no screen stream; folder skipped because '
                    'load_screen_content is enabled',
                    participant_name, stimulus_name)
                continue
            for camera, all_indices in stimulus_segments.items():
                if camera not in cameras_to_use:
                    continue
                # Real recordings start/stop independently; only windows
                # that exist for BOTH the camera and the screen stream are
                # usable (the screen indices feed the refine branch).
                usable = (min(len(all_indices), len(screen_segments))
                          if screen_segments else len(all_indices))
                if usable < len(all_indices):
                    logger.warning(
                        '%s/%s/%s: camera has %d windows but screen has %d;'
                        ' keeping %d', participant_name, stimulus_name,
                        camera, len(all_indices), len(screen_segments),
                        usable)
                for i in range(usable):
                    all_subfolders.append({
                        'camera_name': camera,
                        'participant': participant_name,
                        'subfolder': stimulus_name,
                        'partial_path': '%s/%s' % (participant_name,
                                                   stimulus_name),
                        'full_path': os.path.join(dataset_path,
                                                  participant_name,
                                                  stimulus_name),
                        'indices': all_indices[i],
                        'screen_indices': (screen_segments[i]
                                           if screen_segments else []),
                    })
    return all_subfolders
