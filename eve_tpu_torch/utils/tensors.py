"""Batches and recurrent-state trees as tensors, without the model code.

``tree_map`` maps over the nested dicts and tuples of a recurrent state
(``models.eve.init_stream_state``); ``batch_to_tensors`` moves a numpy or
tensor batch to a device. The serving engine and AOT artifacts
(``eve_tpu_torch.export``) use them without importing ``models``.
"""

import numpy as np
import torch


def tree_map(fn, *trees):
    """Map over matching nested dicts and tuples (recurrent states)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def batch_to_tensors(batch, device):
    """numpy or tensor batch -> tensors on ``device`` (float64 -> float32)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            v = torch.from_numpy(np.require(v, requirements=('C', 'W')))
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.float64:
                v = v.float()
            out[k] = v.to(device, non_blocking=True)
    return out
