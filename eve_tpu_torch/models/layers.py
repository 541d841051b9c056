"""Shared layers, NCHW: instance norm, adaptive max-pool, bilinear resize.

The counterpart of ``eve_tpu/models/layers.py``. eve_tpu emulates torch's
own semantics (adaptive max-pool windows, bilinear resize with
``align_corners=False``), so here they are torch's functions.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class InstanceNorm(nn.Module):
    """InstanceNorm2d: biased variance, eps 1e-5, no running statistics.

    ``affine`` adds ``weight``/``bias`` (the reference's state_dict names).
    The statistics are float32: the port runs float32 only (bfloat16 is a
    later slice).
    """

    def __init__(self, num_features, affine=False, eps=1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter('weight', None)
            self.register_parameter('bias', None)

    def forward(self, x):
        # Two-pass statistics, as eve_tpu; unlike F.instance_norm this also
        # takes 1x1 maps (which it maps to 0, as the reference model does).
        mean = x.mean(dim=(-2, -1), keepdim=True)
        xc = x - mean
        var = (xc * xc).mean(dim=(-2, -1), keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y


def adaptive_max_pool(x, out_hw):
    """AdaptiveMaxPool2d: window [floor(i*n/o), ceil((i+1)*n/o)), e.g. 9 -> 5."""
    return F.adaptive_max_pool2d(x, tuple(out_hw))


def resize_bilinear(x, out_hw):
    """Bilinear resize with ``align_corners=False`` and no antialiasing."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode='bilinear',
                         align_corners=False, antialias=False)
