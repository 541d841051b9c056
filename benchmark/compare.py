"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference gives for the same inputs.

- ``frame_gaps``: each frame's Euclidean distance, in screen px, between
  two (..., 2) point-of-gaze arrays; ``summary`` its mean (the number
  compared) and its quantiles (printed beside it).
- ``nmse``: the squared gaps' sum over the reference's squared spread
  about its own mean: the share of the reference's variation that the
  program gets wrong.
- ``leaf_gaps``: each leaf's gap between the program's norm of the leaf
  and the reference's, against the larger of the reference's norm of that
  leaf and of the median leaf (some leaves' norms are all but zero);
  ``leaf_gap`` the worst of them.
"""

import numpy as np


def frame_gaps(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return np.sqrt((d * d).sum(-1)).reshape(-1)


def summary(gaps):
    return {'mean': float(gaps.mean()),
            'p50': float(np.percentile(gaps, 50)),
            'p99': float(np.percentile(gaps, 99)),
            'max': float(gaps.max()), 'frames': int(gaps.size)}


def nmse(got, want):
    got = np.asarray(got, np.float64).reshape(-1, 2)
    want = np.asarray(want, np.float64).reshape(-1, 2)
    spread = ((want - want.mean(0)) ** 2).sum()
    return float(((got - want) ** 2).sum() / max(spread, 1e-30))


def leaf_gaps(got_norms, want_norms):
    """``got_norms``/``want_norms``: {leaf: norm}. Each leaf's gap."""
    floor = float(np.median(list(want_norms.values())))
    return {k: abs(got_norms[k] - want) / max(want, floor, 1e-30)
            for k, want in want_norms.items()}


def leaf_gap(got_norms, want_norms):
    """``(gap, leaf)`` of the worst leaf."""
    gaps = leaf_gaps(got_norms, want_norms)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
