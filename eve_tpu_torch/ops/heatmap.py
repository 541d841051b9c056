"""Heatmap rendering, soft-argmax and the gaze-history recurrence.

The counterpart of ``eve_tpu/ops/heatmap.py``. The plain versions
(``make_heatmaps``, ``soft_argmax``) are the ones beside the kernels in
``eve_tpu_torch/kernels/heatmap_kernels.py``. The dispatchers
``make_heatmaps_multi_fast`` / ``make_heatmaps_fast`` / ``soft_argmax_fast``
take any leading dims and go through the kernels' custom ops
(``eve_tpu_torch::render_heatmaps``, ``eve_tpu_torch::soft_argmax``) on
every device: on a CUDA tensor the op launches its kernel, on a CPU tensor
it runs the plain version, and ``torch.export`` keeps it as one node.
There is no switch. The multi-sigma form renders several sigmas,
optionally times a per-centre mask, in one launch.

``history_update`` / ``decayed_history_scan`` are the O(T) recurrence
H_t = decay^dt * H_{t-1} + valid_t * h_t, with zero-timestamp (padded)
frames skipped.
"""

import torch

from eve_tpu_torch.kernels.heatmap_kernels import (
    HEATMAP_H, HEATMAP_W, SCREEN_SIZE, SOFTARGMAX_BETA,
    make_heatmaps_multi_plain as make_heatmaps_multi,
    make_heatmaps_plain as make_heatmaps, render_heatmaps,
    soft_argmax as soft_argmax_op, soft_argmax_plain as soft_argmax)

__all__ = ['make_heatmaps', 'make_heatmaps_multi', 'soft_argmax',
           'make_heatmaps_multi_fast', 'make_heatmaps_fast',
           'soft_argmax_fast', 'history_update', 'decayed_history_scan']


def history_update(carry, heatmap, timestamp, validity, decay_per_ms=0.999):
    """One step of the decayed gaze-history recurrence.

    Args:
      carry: ``(H, last_ts)`` with H (..., H, W) float32 and last_ts (...,)
        float32 (0 means "no frame seen yet").
      heatmap: (..., H, W) history-sigma heatmap for this frame.
      timestamp: (...,) frame timestamp in nanoseconds (0 for padded frames).
      validity: (...,) 0/1 validity gate for this frame.

    Returns ``(new_carry, history_map)``.
    """
    H, last_ts = carry
    is_real = timestamp > 0
    dt_ms = (timestamp - last_ts) * 1e-6
    decay = torch.pow(torch.tensor(decay_per_ms, dtype=torch.float32,
                                   device=dt_ms.device), dt_ms)
    # First real frame: no decay of the (zero) history; padded frame: freeze.
    scale = torch.where(is_real & (last_ts > 0), decay,
                        torch.ones_like(decay))
    add = torch.where(is_real, validity.to(H.dtype), torch.zeros_like(H[..., 0, 0]))
    new_H = scale[..., None, None] * H + add[..., None, None] * heatmap
    new_last = torch.where(is_real, timestamp, last_ts)
    new_H = torch.where(is_real[..., None, None], new_H, H)
    return (new_H, new_last), new_H


def decayed_history_scan(heatmaps, timestamps, validities, decay_per_ms=0.999):
    """(B, T, H, W) maps, (B, T) stamps and validities -> (B, T, H, W)."""
    B, T, h, w = heatmaps.shape
    carry = (torch.zeros((B, h, w), dtype=torch.float32,
                         device=heatmaps.device),
             torch.zeros((B,), dtype=torch.float32, device=heatmaps.device))
    out = []
    for t in range(T):
        carry, hist = history_update(
            carry, heatmaps[:, t].float(), timestamps[:, t].float(),
            validities[:, t], decay_per_ms=decay_per_ms)
        out.append(hist)
    return torch.stack(out, dim=1)


def make_heatmaps_multi_fast(centres_px, sigmas, multiplier=None,
                             heatmap_size=(HEATMAP_W, HEATMAP_H),
                             actual_screen_size=SCREEN_SIZE):
    """(..., 2) centres -> (S, ..., H, W), one render launch on the card.

    ``multiplier`` (shape ``centres_px.shape[:-1]``), if given, multiplies
    each centre's maps, as a validity mask does.
    """
    lead = centres_px.shape[:-1]
    flat = centres_px.reshape(-1, 2).float().contiguous()
    if multiplier is not None:
        multiplier = multiplier.reshape(-1).float().contiguous()
    out = render_heatmaps(flat, sigmas, multiplier, heatmap_size,
                          actual_screen_size)
    return out.reshape((out.shape[0],) + lead + out.shape[2:])


def make_heatmaps_fast(centres_px, sigma, heatmap_size=(HEATMAP_W, HEATMAP_H),
                       actual_screen_size=SCREEN_SIZE):
    """``make_heatmaps`` through the render op."""
    return make_heatmaps_multi_fast(centres_px, (sigma,), None, heatmap_size,
                                    actual_screen_size)[0]


def soft_argmax_fast(heatmaps, heatmap_size=(HEATMAP_W, HEATMAP_H),
                     actual_screen_size=SCREEN_SIZE,
                     beta=SOFTARGMAX_BETA):
    """``soft_argmax`` through the soft-argmax op."""
    lead = heatmaps.shape[:-2]
    flat = heatmaps.reshape((-1,) + tuple(heatmaps.shape[-2:])).contiguous()
    out = soft_argmax_op(flat, heatmap_size, actual_screen_size, beta)
    return out.reshape(lead + (2,))
