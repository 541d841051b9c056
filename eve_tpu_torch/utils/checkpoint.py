"""Read model parameters from an eve_tpu run directory.

eve_tpu writes checkpoints as directories ``<run>/checkpoints/NNNNNNN.ckpt``
holding one ``.npz`` per top-level parameter prefix (``eye_net.npz``,
``refine_net.npz``), each a '/'-flattened tree, plus ``optimizer_0.*``. This
is the read side of ``eve_tpu/train/checkpoint.py`` for serving: the newest
checkpoint's parameter trees, not the optimizer state.
"""

import glob
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

_SUFFIX = '.ckpt'
# npz key marking an empty dict node in eve_tpu's flattened trees.
_EMPTY = '__empty__'


def unflatten_tree(flat):
    """{'a/b/c': array} -> nested dicts of arrays."""
    root = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == _EMPTY:
            continue
        node[parts[-1]] = value
    return root


def available_checkpoints(run_dir):
    """Sorted ``[(step, path)]`` of the checkpoint directories of a run."""
    entries = []
    for path in glob.glob(os.path.join(run_dir, 'checkpoints', '*' + _SUFFIX)):
        if not os.path.isdir(path):
            continue
        try:
            step = int(os.path.basename(path)[:-len(_SUFFIX)])
        except ValueError:
            continue
        entries.append((step, path))
    return sorted(entries)


def load_params(checkpoint_dir):
    """Parameter trees of one checkpoint directory, keyed by prefix."""
    params = {}
    for npz_path in sorted(glob.glob(os.path.join(checkpoint_dir, '*.npz'))):
        name = os.path.basename(npz_path)[:-len('.npz')]
        if name.startswith('optimizer_'):
            continue
        with np.load(npz_path) as data:
            params[name] = unflatten_tree({k: data[k] for k in data.files})
        logger.info('> Loaded model parameters from: %s', npz_path)
    return params


def load_last_params(run_dir):
    """``(params, step)`` of the newest checkpoint of ``run_dir``."""
    available = available_checkpoints(run_dir)
    if not available:
        raise FileNotFoundError('no checkpoint found in %s' % run_dir)
    step, path = available[-1]
    return load_params(path), step
