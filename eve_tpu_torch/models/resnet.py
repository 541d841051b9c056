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

``stem`` selects eve_tpu's stem: 'reference' (above), or one of the opt-in
topology's patch-embedding stems in its place, 'patchify' (an 8x8 stride-4
convolution, padding 2, straight to layer1's resolution) or 'patchify8'
(8x8, stride 8, no padding), each without bias and followed by a non-affine
instance norm and a ReLU (``stem_conv``, eve_tpu's name). The two have the
same parameters; only the stride differs.
"""

import logging

import torch
import torch.nn as nn
import torch.nn.functional as F

from eve_tpu_torch.models.layers import Conv2d, InstanceNorm

logger = logging.getLogger(__name__)

# The opt-in topology's patch-embedding stems: their strides.
STEM_STRIDES = {'patchify': 4, 'patchify8': 8}


class BasicBlock(nn.Module):
    def __init__(self, in_features, features, stride=1):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.in1 = InstanceNorm(features, act='relu')
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.in2 = InstanceNorm(features)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_features, features, 1, stride, 0, bias=False),
                InstanceNorm(features))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.in1(self.conv1(x))
        out = self.in2(self.conv2(out))
        return F.relu(out + identity)


class ResNet18IN(nn.Module):
    """(N, 3, H, W) in [-1, 1] -> (N, num_classes)."""

    def __init__(self, num_classes=128, compute_dtype=torch.float32,
                 stem='reference'):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = stem
        if stem == 'reference':
            self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        elif stem in STEM_STRIDES:
            stride = STEM_STRIDES[stem]
            self.stem_conv = Conv2d(3, 64, 8, stride, (8 - stride) // 2,
                                    bias=False)
        else:
            # A typo'd stem must not silently train the reference stem.
            raise ValueError(
                "Unknown ResNet18IN stem %r (expected 'reference', "
                "'patchify' or 'patchify8')" % (stem,))
        self.in1 = InstanceNorm(64, act='relu')
        in_features = 64
        for stage, (features, stride) in enumerate(
                ((64, 1), (128, 2), (256, 2), (512, 2))):
            self.add_module('layer%d' % (stage + 1), nn.Sequential(
                BasicBlock(in_features, features, stride),
                BasicBlock(features, features, 1)))
            in_features = features
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        # Below this size layer4 runs at 1x1, where instance norm maps
        # every activation to 0 and the output ignores the input.
        min_px = 65 if self.stem == 'patchify8' else 33
        if min(x.shape[-2:]) < min_px:
            logger.warning('ResNet18IN input %s is below %dpx (stem=%s): '
                           'instance norm at the 1x1 layer4 resolution '
                           'erases the pixel signal.', tuple(x.shape),
                           min_px, self.stem)
        x = x.to(self.compute_dtype)
        if self.stem == 'reference':
            x = self.in1(self.conv1(x))
            x = F.max_pool2d(x, 3, 2, 1)
        else:
            x = self.in1(self.stem_conv(x))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        pooled = x.mean(dim=(-2, -1), dtype=torch.float32).to(x.dtype)
        return self.fc(pooled.float())
