"""Shared layers, NCHW: convolution, instance norm, batch norm (eval),
adaptive max-pool, bilinear resize, depth-to-space, channel concatenation.

The counterpart of ``eve_tpu/models/layers.py``. eve_tpu emulates torch's
own semantics (adaptive max-pool windows, bilinear resize with
``align_corners=False``), so here they are torch's functions.

Memory layout: the shapes are always (N, C, H, W), but where the networks
compute in bfloat16 on the card (``runs_channels_last``) the activations
are stored channels-last (NHWC): cuDNN's bf16 convolutions are NHWC
kernels, and NCHW tensors would cost a transpose on each side of every
convolution. ``Conv2d`` then keeps its cast weight channels-last, so its
output is channels-last whatever its input; the norm, the resize and the
concatenation keep their input's layout. float32 (cuDNN's NCHW kernels with
TF32 off) and the CPU (held to eve_tpu bitwise) stay NCHW.

Compute type: the parameters are float32 whatever the network computes in.
A bfloat16 activation times a float32 parameter would promote to float32
and silently run the rest of the network in float32, so every layer that
holds a parameter casts it to the activation's type, as eve_tpu's layers
do (``kernel.astype(x.dtype)``).
"""

import functools
import itertools
import struct

import torch
import torch.nn as nn
import torch.nn.functional as F

from eve_tpu_torch.kernels import norm_kernels

# LeakyReLU's negative slope in the networks.
LEAKY_SLOPE = 0.01


def runs_channels_last(dtype, device):
    """Whether a network computing in ``dtype`` on ``device`` stores its
    activations channels-last: bfloat16 on the card."""
    return dtype == torch.bfloat16 and torch.device(device).type == 'cuda'


def is_channels_last(x):
    """Whether ``x`` (N, C, H, W) keeps its channels innermost (stride 1)
    with more than one channel and more than one value a map, where the two
    layouts differ."""
    return (x.dim() == 4 and x.shape[1] > 1 and x.shape[2] * x.shape[3] > 1
            and x.stride(1) == 1)


# Elements a CUDA concatenation writes with its batched copy kernel; from
# 2^31 on it copies each input apart with strided element-wise kernels.
CAT_INDEX_LIMIT = 2 ** 31 - 1


def cat_channels(tensors):
    """``torch.cat(tensors, dim=1)``, channels-last where any input is
    (``torch.cat`` gives NCHW for inputs of mixed layouts, e.g. a 1-channel
    map beside a channels-last one): one copy kernel either way.

    A channels-last output of ``CAT_INDEX_LIMIT`` elements or more
    (RefineNet's level-0 decoder input at a Codalab batch) is concatenated
    in slices of the batch into one output where nothing records the call,
    so that each slice takes the batched kernel.
    """
    if not any(is_channels_last(t) for t in tensors):
        return torch.cat(tensors, dim=1)
    nhwc = [t.permute(0, 2, 3, 1) for t in tensors]
    n, h, w = nhwc[0].shape[:3]
    c = sum(t.shape[3] for t in nhwc)
    per = max(1, CAT_INDEX_LIMIT // (h * w * c))
    if n <= per or not norm_kernels.eager(*tensors):
        return torch.cat(nhwc, dim=3).permute(0, 3, 1, 2)
    out = nhwc[0].new_empty((n, h, w, c))
    for i in range(0, n, per):
        torch.cat([t[i:i + per] for t in nhwc], dim=3, out=out[i:i + per])
    return out.permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same state_dict names) that computes in its
    input's type: the weight and bias are cast to ``x.dtype``.

    At float32 this is ``nn.Conv2d`` itself, the bias fused into the
    convolution. At bfloat16 the bias is added after the convolution, in
    bfloat16, as eve_tpu's ``Conv`` adds it (``y + bias.astype(x.dtype)``):
    a fused bias rounds the sum once, eve_tpu rounds the convolution and
    then the sum, and the two differ by a bfloat16 ulp at about a third of
    the outputs (measured on the CPU, where the separate add matches
    eve_tpu's outputs bitwise). At float32 the two orders differ in the
    last bit only, and the fused form saves a pass over the output.

    Without autograd the cast weight and bias are kept from call to call
    (``_casts``), so that a forward launches no casts. Where
    ``runs_channels_last`` holds, the cast weight is channels-last, so cuDNN
    neither converts it at each call nor writes an NCHW output.
    """

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        weight, bias = self._casts(
            x.dtype, torch.channels_last if runs_channels_last(
                x.dtype, x.device) else torch.contiguous_format)
        y = self._conv_forward(x, weight, None)
        return y if bias is None else y + bias

    def _casts(self, dtype, memory_format=torch.contiguous_format):
        """The weight (in ``memory_format``) and the bias (as (C, 1, 1), or
        None) in ``dtype``.

        Where ``norm_kernels.eager`` holds and the parameters track their
        versions (none is an inference tensor), the casts made at one call
        serve the next while each parameter holds the same storage at the
        same version: an in-place change (an optimizer's step,
        ``load_state_dict``) bumps the version, and the cache holds the
        source parameters' storage, so no other tensor can take its
        address. Otherwise, as under autograd, they are cast at each call,
        so that the casts are in the graph.
        """
        w, b = self.weight, self.bias
        params = (w,) if b is None else (w, b)
        if torch.is_grad_enabled() or not norm_kernels.eager(*params) or \
                any(p.is_inference() for p in params):
            return w.to(dtype, memory_format=memory_format), \
                None if b is None else b.to(dtype)[:, None, None]
        key = (dtype, memory_format) + tuple((p.data_ptr(), p._version)
                                             for p in params)
        cached = self.__dict__.get('_cast_cache')
        if cached is None or cached[0] != key:
            # Outside inference mode, so that the casts also serve a
            # forward under torch.no_grad.
            with torch.inference_mode(False):
                casts = (w.detach().to(dtype, memory_format=memory_format),
                         None if b is None else
                         b.detach().to(dtype)[:, None, None])
            cached = (key, [p.detach() for p in params], casts)
            self.__dict__['_cast_cache'] = cached
        return cached[2]


class InstanceNorm(nn.Module):
    """InstanceNorm2d: biased variance, eps 1e-5, no running statistics,
    then the activation ``act`` (None, 'relu' or 'leaky': ``LeakyReLU``
    with slope ``LEAKY_SLOPE``) that follows the norm in the network.

    ``affine`` adds ``weight``/``bias`` (the reference's state_dict names).
    The statistics are float32 for any input type (eve_tpu's
    ``instance_norm``):

    - float32 input: two-pass statistics, ``(x - mean) * rsqrt(var + eps)``,
      then the activation, in plain PyTorch on either device.
    - bfloat16 input: ``kernels.norm_kernels.instance_norm``, the one-pass
      float32 statistics (``E[x^2] - E[x]^2``, clamped at 0), the affine
      weight and bias folded into a float32 ``scale`` and ``shift``, which
      are cast to bfloat16 and applied as ``x * scale + shift`` in
      bfloat16, and the activation: one kernel launch on the card, its
      plain version on the CPU.

    A 1x1 map normalises to 0 (then ``bias``), as the reference model's
    norm gives. The float32 form gets there by itself; in the bfloat16 form
    ``x * scale`` and ``shift`` round separately at a scale of
    ``rsqrt(eps)`` ~ 316, and eve_tpu leaves their difference (up to 16,
    measured) where the map should be 0, so the port returns the exact
    value there instead. Only ResNet-18's layer4 below 33 px eyes meets a
    1x1 map.
    """

    def __init__(self, num_features, affine=False, eps=1e-5, act=None):
        super().__init__()
        if act not in (None, 'relu', 'leaky'):
            raise ValueError("InstanceNorm act %r is not None, 'relu' or "
                             "'leaky'" % (act,))
        self.num_features = num_features
        self.eps = eps
        self.act = act
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter('weight', None)
            self.register_parameter('bias', None)

    def forward(self, x):
        slope = _rounded(LEAKY_SLOPE, x.dtype)
        if x.dtype != torch.float32:
            return norm_kernels.instance_norm(
                x, self.weight, self.bias, self.eps, self.act or 'none',
                slope)
        # Two-pass statistics, as eve_tpu; unlike F.instance_norm this
        # also takes 1x1 maps (which it maps to 0).
        mean = x.mean(dim=(-2, -1), keepdim=True)
        xc = x - mean
        var = (xc * xc).mean(dim=(-2, -1), keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return norm_kernels.activate(y, self.act, slope)


class BatchNorm(nn.Module):
    """BatchNorm2d's state as torch names it (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``; eps 1e-5),
    for loading. It has no forward: models fold it into the convolution
    before it (``ResNet18BN.fold_norms``), which evaluates it exactly in
    real arithmetic.
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    """``value`` rounded to ``dtype``, as a Python float: to float32, then
    to bfloat16 by round-to-nearest-even on the float32 bit pattern (as
    torch rounds a float32 tensor) or to float16 by ``struct``. Plain
    Python, so a traced forward sees (and the cache keeps) a constant; a
    tensor made while tracing would be a data-dependent symbol."""
    if dtype == torch.float64:
        return float(value)
    if dtype == torch.float16:
        return struct.unpack('<e', struct.pack('<e', value))[0]
    (bits,) = struct.unpack('<I', struct.pack('<f', value))
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack('<f', struct.pack('<I', bits))[0]


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` whose slope is of its input's type, as eve_tpu's:
    jax's weak-typed ``0.01 * x`` rounds the slope to bfloat16
    (0.010009765625) for a bfloat16 ``x``. At float32 this is
    ``nn.LeakyReLU``."""

    def forward(self, x):
        return F.leaky_relu(x, _rounded(self.negative_slope, x.dtype),
                            self.inplace)


@functools.lru_cache(maxsize=None)
def _pool_window(n, o):
    """``(kernel, stride, padding)`` of a max-pool whose windows over ``n``
    values, clipped to them, are the adaptive pool's ``o`` windows, or None
    where none is."""
    windows = [(i * n // o, -(-(i + 1) * n // o)) for i in range(o)]
    # The stride is a step between starts (the first start may be clipped).
    strides = {b[0] - a[0] for a, b in zip(windows, windows[1:])} or {n}
    for stride, kernel in itertools.product(sorted(strides),
                                            range(1, n + 1)):
        for padding in range(kernel // 2 + 1):
            if (n + 2 * padding - kernel) // stride + 1 == o and windows == [
                    (max(i * stride - padding, 0),
                     min(i * stride - padding + kernel, n))
                    for i in range(o)]:
                return kernel, stride, padding
    return None


def adaptive_max_pool(x, out_hw):
    """AdaptiveMaxPool2d: window [floor(i*n/o), ceil((i+1)*n/o)), e.g. 9 -> 5.

    Where a plain max-pool has the same windows (every level of RefineNet:
    halvings, and 9 -> 5 as kernel 3, stride 2, padding 1), it runs as one:
    the same maxima, and on the card a channels-last kernel, where the
    adaptive pool has only an NCHW one and copies a channels-last input
    there and its outputs back.
    """
    h, w = _pool_window(x.shape[-2], out_hw[0]), _pool_window(x.shape[-1],
                                                              out_hw[1])
    if h is None or w is None:
        return F.adaptive_max_pool2d(x, tuple(out_hw))
    return F.max_pool2d(x, (h[0], w[0]), (h[1], w[1]), (h[2], w[2]))


def _resize_weights(n_in, n_out, device, dtype):
    """(n_in, n_out) bilinear weights of ``jax.image.resize`` (triangle
    kernel, no antialiasing): computed in float32 as jax computes them,
    then cast to ``dtype``. Cached for eager calls; a traced call
    (``torch.export``) builds the matrix in its graph instead, since a
    tensor made while tracing is a fake one and must not be kept."""
    if torch.compiler.is_compiling():
        return _build_resize_weights(n_in, n_out, device, dtype)
    return _cached_resize_weights(n_in, n_out, device, dtype)


def _build_resize_weights(n_in, n_out, device, dtype):
    # Outside inference mode, so that a cached matrix may also serve a
    # forward that records a graph.
    with torch.inference_mode(False):
        inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32,
                           device=device)
        sample = (torch.arange(n_out, dtype=torch.float32, device=device)
                  + 0.5) * inv - 0.5
        grid = torch.arange(n_in, dtype=torch.float32, device=device)
        w = torch.clamp(1.0 - (sample[None, :] - grid[:, None]).abs(),
                        min=0.0)
        w = w / w.sum(dim=0, keepdim=True)
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        return torch.where(inside[None, :], w, 0.0).to(dtype)


_cached_resize_weights = functools.lru_cache(maxsize=None)(
    _build_resize_weights)


def resize_bilinear(x, out_hw):
    """Bilinear resize with ``align_corners=False`` and no antialiasing.

    At float32, ``F.interpolate``. At bfloat16, eve_tpu's
    ``jax.image.resize`` as it computes: the weight matrices rounded to
    bfloat16, a contraction over the width and then one over the height,
    each rounded to bfloat16. ``F.interpolate`` rounds once from float32
    weights and differs from eve_tpu by a bfloat16 ulp at ~30% of the
    outputs (measured on the CPU, where the two contractions match eve_tpu
    bitwise). A channels-last input is contracted over its NHWC storage
    (the width as a product batched over N*H, then the height batched over
    N) and comes out channels-last: the same order and roundings, with no
    copy to NCHW.
    """
    out_h, out_w = tuple(out_hw)
    if (out_h, out_w) == tuple(x.shape[-2:]):
        return x
    if x.dtype == torch.float32:
        return F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                             align_corners=False, antialias=False)
    w_w = _resize_weights(x.shape[-1], out_w, x.device, x.dtype)
    w_h = _resize_weights(x.shape[-2], out_h, x.device, x.dtype)
    if not is_channels_last(x):
        return torch.matmul(w_h.t(), torch.matmul(x, w_w))
    n, c, h, w = x.shape
    y = torch.matmul(w_w.t(), x.permute(0, 2, 3, 1).reshape(n * h, w, c))
    y = torch.matmul(w_h.t(), y.reshape(n, h, out_w * c))
    return y.reshape(n, out_h, out_w, c).permute(0, 3, 1, 2)


def depth_to_space(x, block):
    """Sub-pixel reshape (N, b*b*C, H, W) -> (N, C, H*b, W*b), reading the
    channel axis as eve_tpu's (bh, bw, C): channel ``(i*b + j)*C + c``
    paints pixel (i, j) of its cell's b x b tile in output channel c.
    ``F.pixel_shuffle`` reads it as (C, bh, bw); the two agree only at
    C = 1."""
    n, c, h, w = x.shape
    if c % (block * block):
        raise ValueError('%d channels do not split into %dx%d tiles'
                         % (c, block, block))
    c_out = c // (block * block)
    x = x.reshape(n, block, block, c_out, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)  # (N, C, H, bh, W, bw)
    return x.reshape(n, c_out, h * block, w * block)
