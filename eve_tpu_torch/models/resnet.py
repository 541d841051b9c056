"""ResNet-18 with instance normalization (the EyeNet backbone) or with
batch normalization (Gaze360's), NCHW.

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

``ResNet18BN`` is torchvision's ``resnet18`` as Gaze360 builds it (its
``base_model``): the same stem and stages with eval-mode ``BatchNorm``
(``bn1``, ``layer{1..4}.{0,1}.bn{1,2}``, ``downsample.1``), the global
average pool (torchvision's 7x7 pool at 224x224), then ``fc1`` 512 -> 1000,
ReLU and ``fc2`` 1000 -> ``num_features``. Both networks share
``BasicBlock`` and ``layers.Conv2d`` (with its bf16 cast cache).
``fold_norms`` folds each norm into the convolution before it, and the
network runs only folded: ``layers.BatchNorm`` holds the loaded state and
has no forward.
"""

import logging

import torch
import torch.nn as nn
import torch.nn.functional as F

from eve_tpu_torch.models.layers import BatchNorm, Conv2d, InstanceNorm

logger = logging.getLogger(__name__)

# The opt-in topology's patch-embedding stems: their strides.
STEM_STRIDES = {'patchify': 4, 'patchify8': 8}
# A block's norms: the state_dict names' prefix.
NORM_PREFIXES = {'instance': 'in', 'batch': 'bn'}


def _norm(kind, features, act=None):
    """An ``InstanceNorm`` with its activation, or a ``BatchNorm`` (whose
    activation ``fold_norms`` puts in its place)."""
    if kind == 'instance':
        return InstanceNorm(features, act=act)
    return BatchNorm(features)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions, each followed by a norm (the first with its
    ReLU), and a 1x1 convolution + norm shortcut where the block strides.
    ``norm`` 'instance' names the norms ``in1``/``in2``, 'batch'
    ``bn1``/``bn2`` (torchvision's)."""

    def __init__(self, in_features, features, stride=1, norm='instance'):
        super().__init__()
        prefix = NORM_PREFIXES[norm]
        self._norms = (prefix + '1', prefix + '2')
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.add_module(self._norms[0], _norm(norm, features, act='relu'))
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.add_module(self._norms[1], _norm(norm, features))
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_features, features, 1, stride, 0, bias=False),
                _norm(norm, features))

    def forward(self, x):
        norm1, norm2 = (getattr(self, name) for name in self._norms)
        identity = x if self.downsample is None else self.downsample(x)
        out = norm1(self.conv1(x))
        out = norm2(self.conv2(out))
        return F.relu(out + identity)

    def conv_norm_pairs(self):
        """``[(parent, conv, norm name, activation)]`` of each convolution
        and the norm after it, with the activation after the norm."""
        pairs = [(self, self.conv1, self._norms[0], 'relu'),
                 (self, self.conv2, self._norms[1], None)]
        if self.downsample is not None:
            pairs.append((self.downsample, self.downsample[0], '1', None))
        return pairs


def _stages(module, norm):
    in_features = 64
    for stage, (features, stride) in enumerate(
            ((64, 1), (128, 2), (256, 2), (512, 2))):
        module.add_module('layer%d' % (stage + 1), nn.Sequential(
            BasicBlock(in_features, features, stride, norm),
            BasicBlock(features, features, 1, norm)))
        in_features = features


def _run_stages(module, x):
    return module.layer4(module.layer3(module.layer2(module.layer1(x))))


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
        _stages(self, 'instance')
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
        x = _run_stages(self, x)
        pooled = x.mean(dim=(-2, -1), dtype=torch.float32).to(x.dtype)
        return self.fc(pooled.float())


class ResNet18BN(nn.Module):
    """(N, 3, H, W) normalised frames -> (N, num_features): Gaze360's
    ``base_model`` (see the module docstring).

    ``compute_dtype``: the stem and the stages run in it (the input is
    cast to it; a channels-last input stays channels-last), the global
    average pool accumulates in float32, and ``fc1``, the ReLU and ``fc2``
    run float32, as EyeNet's policy has it.
    """

    def __init__(self, num_features=256, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        _stages(self, 'batch')
        self.fc1 = nn.Linear(512, 1000)
        self.fc2 = nn.Linear(1000, num_features)

    def forward(self, x):
        x = self.bn1(self.conv1(x.to(self.compute_dtype)))
        x = _run_stages(self, F.max_pool2d(x, 3, 2, 1))
        pooled = x.mean(dim=(-2, -1), dtype=torch.float32)
        return self.fc2(F.relu(self.fc1(pooled)))

    def conv_norm_pairs(self):
        pairs = [(self, self.conv1, 'bn1', 'relu')]
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                pairs += block.conv_norm_pairs()
        return pairs

    @torch.no_grad()
    def fold_norms(self):
        """Fold each eval ``BatchNorm`` into the convolution before it and
        put its activation in its place: the weight times
        ``weight / sqrt(running_var + eps)`` per output channel, the bias
        ``bias - running_mean * weight / sqrt(running_var + eps)``
        (computed in float64, stored float32). Exact in real arithmetic;
        the state_dict then holds the convolutions' biases and no norm."""
        for parent, conv, name, act in self.conv_norm_pairs():
            norm = getattr(parent, name)
            if not isinstance(norm, BatchNorm):
                continue
            scale = (norm.weight.double()
                     * torch.rsqrt(norm.running_var.double() + norm.eps))
            conv.weight = nn.Parameter(
                (conv.weight.double() * scale[:, None, None, None])
                .to(conv.weight.dtype))
            conv.bias = nn.Parameter(
                (norm.bias.double() - norm.running_mean.double() * scale)
                .to(conv.weight.dtype))
            parent.add_module(name, nn.ReLU(inplace=True)
                              if act == 'relu' else nn.Identity())
        return self
