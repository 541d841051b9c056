"""In-memory synthetic clips for the port's harness tests (CPU, tests only).

``SyntheticSequences`` has the EVE reader's constructor, so the harness's
spec tuples ``(tag, SyntheticSequences, (seed, n), stimuli, cameras)``
build it as they build ``EVESequences_*``, the final full test included.
``path`` is ``(seed, number of clips)``; the clips have the config's
``max_sequence_len`` frames and ``eyes_size`` eyes, uint8 frames.
"""

import numpy as np

from eve_tpu_torch.data.synthetic import make_synthetic_batch


class SyntheticSequences:
    """``n`` synthetic clips drawn in one go from ``RandomState(seed)``."""

    def __init__(self, path, config, cameras_to_use=None,
                 types_of_stimuli=None, live_validation=False,
                 is_final_test=False):
        seed, n = path
        batch = make_synthetic_batch(
            np.random.RandomState(seed), batch_size=n,
            sequence_len=config.max_sequence_len,
            eyes_size=config.eyes_size[0], frame_dtype=np.uint8)
        self.clips = [{k: v[i] for k, v in batch.items()} for i in range(n)]
        self.live_validation = live_validation
        self.is_final_test = is_final_test

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def specs(tag, seed, n):
    """One spec tuple of ``n`` clips."""
    return (tag, SyntheticSequences, (seed, n), ['image'], ['webcam_c'])
