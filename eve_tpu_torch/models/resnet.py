"""ResNet-18 with instance normalization (the EyeNet backbone), NCHW.

torchvision's ``ResNet(BasicBlock, [2, 2, 2, 2], norm_layer=InstanceNorm2d)``
as the reference EyeNet builds it, with its state_dict names (``conv1``,
``layer{1..4}.{0,1}.conv{1,2}``, ``downsample.0``, ``fc``): 7x7/2 stem and
3x3/2 max-pool, four stages of two basic blocks, global average pool, fc.
The norms are affine-free, so they hold no parameters.

``compute_dtype`` is eve_tpu's: the input is cast to it, the stages run in
it, the global average pool accumulates in float32 and rounds to it, and
the pooled features return to float32 before ``fc``, so everything after
the backbone runs float32.

Only the reference stem is here; the patchify stems of the opt-in topology
are a later slice.
"""

import logging

import torch
import torch.nn as nn
import torch.nn.functional as F

from eve_tpu_torch.models.layers import Conv2d, InstanceNorm

logger = logging.getLogger(__name__)


class BasicBlock(nn.Module):
    def __init__(self, in_features, features, stride=1):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.in1 = InstanceNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.in2 = InstanceNorm(features)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_features, features, 1, stride, 0, bias=False),
                InstanceNorm(features))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.in1(self.conv1(x)))
        out = self.in2(self.conv2(out))
        return F.relu(out + identity)


class ResNet18IN(nn.Module):
    """(N, 3, H, W) in [-1, 1] -> (N, num_classes)."""

    def __init__(self, num_classes=128, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.in1 = InstanceNorm(64)
        in_features = 64
        for stage, (features, stride) in enumerate(
                ((64, 1), (128, 2), (256, 2), (512, 2))):
            self.add_module('layer%d' % (stage + 1), nn.Sequential(
                BasicBlock(in_features, features, stride),
                BasicBlock(features, features, 1)))
            in_features = features
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        if min(x.shape[-2:]) < 33:
            # Below 33 px, layer4 runs at 1x1, where instance norm maps
            # every activation to 0 and the output ignores the input.
            logger.warning('ResNet18IN input %s is below 33px: instance norm '
                           'at the 1x1 layer4 resolution erases the pixel '
                           'signal.', tuple(x.shape))
        x = F.relu(self.in1(self.conv1(x.to(self.compute_dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        pooled = x.mean(dim=(-2, -1), dtype=torch.float32).to(x.dtype)
        return self.fc(pooled.float())
