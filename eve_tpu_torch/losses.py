"""Validity-masked losses over (B, T), computed in float32.

The counterpart of ``eve_tpu/losses/__init__.py``:

per item b:  acc_b = sum_t validity[b,t] * loss[b,t]
             acc_b /= num_valid_b   (only when num_valid_b > 1, the
                                     reference's edge case)
final     :  mean_b acc_b

Every loss takes ``seq``, the grid's seq axis (``parallel.mesh.Axis``)
when the clips' frames are split over ranks: each item's ``acc_b`` and
``num_valid_b`` are then summed over the axis before the divide, so the
edge rule reads the clip's global count and the loss is eve_tpu's global
mean on every rank. (Averaging the ranks' own means would give another
number: a clip's frames are not equally valid on every rank.)
"""

import torch

from eve_tpu_torch.ops.geometry import angular_error_degrees
from eve_tpu_torch.parallel.temporal import seq_sum


def masked_mean(per_frame_loss, validity, seq=None):
    """(B, T) losses and validities -> scalar float32 loss (of the whole
    clips' frames, under ``seq``)."""
    v = validity.float()
    loss = per_frame_loss.float()
    # where (not v * l): invalid frames contribute neither value nor
    # gradient; their loss may be garbage (padded zero labels).
    loss = torch.where(v > 0, loss, torch.zeros_like(loss))
    num_valid = v.sum(dim=1)
    acc = loss.sum(dim=1)
    if seq is not None and seq.size > 1:
        acc, num_valid = seq_sum(torch.stack([acc, num_valid]), seq)
    acc = torch.where(num_valid > 1, acc / torch.clamp(num_valid, min=1.0),
                      acc)
    return acc.mean()


def _feature_dims(x):
    """Dims beyond (B, T)."""
    return tuple(range(2, x.ndim))


def mse_loss(pred, gt, validity, seq=None):
    """Per-frame mean squared error over the feature dims."""
    sq = torch.square(pred.float() - gt.float())
    per_frame = sq.mean(dim=_feature_dims(pred)) if pred.ndim > 2 else sq
    return masked_mean(per_frame, validity, seq)


def l1_loss(pred, gt, validity, seq=None):
    """Per-frame mean absolute error over the feature dims.

    Where prediction equals label the gradient is +1, as ``jnp.abs``'s is
    (``torch.abs`` gives 0 there).
    """
    d = pred.float() - gt.float()
    ab = torch.where(d >= 0, d, -d)
    per_frame = ab.mean(dim=_feature_dims(pred)) if pred.ndim > 2 else ab
    return masked_mean(per_frame, validity, seq)


def euclidean_loss(pred, gt, validity, seq=None):
    """Per-frame sqrt of the summed squared difference.

    Double-where guards the sqrt: at ssd == 0 its gradient is infinite, and
    even a zero cotangent gives 0 * inf = NaN without the guard.
    """
    ssd = torch.square(pred.float() - gt.float()).sum(dim=_feature_dims(pred))
    positive = ssd > 0.0
    safe = torch.where(positive, ssd, torch.ones_like(ssd))
    per_frame = torch.where(positive, torch.sqrt(safe), torch.zeros_like(ssd))
    return masked_mean(per_frame, validity, seq)


def angular_loss(pred, gt, validity, seq=None):
    """Per-frame angular error in degrees (pitch/yaw or 3D inputs)."""
    per_frame = angular_error_degrees(pred.float(), gt.float())
    return masked_mean(per_frame, validity, seq)


def cross_entropy_loss(pred, gt, validity, seq=None):
    """Per-frame binary cross entropy, mean over heatmap pixels.

    -(y log x + (1-y) log(1-x)) with each log clamped at -100, as
    ``F.binary_cross_entropy``, but saturated pixels (x == 0 or x == 1) get a
    zero gradient: double-where guards keep log's infinite derivative out of
    the backward pass, where torch's own loss gives a clamped large one.
    """
    x = pred.float()
    y = gt.float()
    floor = torch.full_like(x, -100.0)
    pos = x > 0.0
    log_x = torch.where(
        pos, torch.clamp(torch.log(torch.where(pos, x, torch.ones_like(x))),
                         min=-100.0), floor)
    lt1 = x < 1.0
    log_1mx = torch.where(
        lt1, torch.clamp(torch.log1p(-torch.where(lt1, x, torch.zeros_like(x))),
                         min=-100.0), floor)
    ce = -(y * log_x + (1.0 - y) * log_1mx)
    return masked_mean(ce.mean(dim=_feature_dims(ce)), validity, seq)
