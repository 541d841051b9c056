"""Instance norm with its activation: the CUDA kernel, its plain version, the
wrapper.

eve_tpu has no kernel here: its ``instance_norm``
(``eve_tpu/models/layers.py:29``) is jnp, and XLA fuses it with the ReLU or
LeakyReLU after it into one pass over the map. Run eagerly, the port's bf16
form is about 16 launches a norm, one more for the activation, and some 34
bytes of device memory an element; ``eve_tpu_torch/csrc/norm_kernels.cu``
does it in one launch, and says how: a channels-last kernel (the bf16
forward on the card runs channels-last) that reads and writes each plane
once (4 bytes an element), and a general kernel (a warp a plane) for any
other shape.

Beside the kernel, in this module:

- the plain PyTorch version (``instance_norm_plain``): the bf16 form of
  ``models.layers.InstanceNorm`` (one-pass float32 statistics, the scale and
  shift rounded to the input's type, two roundings a value), then the
  activation; the CPU runs it, and the kernel is held against it on the
  card;
- a ``torch.library`` custom op (``eve_tpu_torch::instance_norm``): its CPU
  implementation is the plain version, its CUDA implementation launches the
  kernel or raises (there is no fallback), its fake implementation gives
  the output's shape, so that ``torch.export`` traces the op as one node,
  and its backward (``plain_backward``) runs the operations autograd runs
  through the plain version, from the saved input and output, without
  recording a graph: autograd's gradients bitwise, at a fraction of its
  host time a norm;
- the wrapper (``instance_norm``), which calls the op, or, where nothing
  records the call (no autograd graph, no tracing, no dispatch mode), the
  op's CUDA implementation straight away: the op's dispatch doubles the
  host time of a call, and the host sets the pace of a bf16 forward;
- the layout choice (``layout``): a channels-last input that
  ``nhwc_launch`` tiles takes the NHWC kernel, with its output
  channels-last too; any other input (NCHW, a 1x1 map, a channel count
  that is not a multiple of 8, a map too large for a cluster) the general
  kernel on a contiguous copy where it is not contiguous already;
- a launch count (``LAUNCHES``), bumped once per kernel launch and nowhere
  else.

The float32 form (two-pass statistics) is another function and stays in
``models.layers``.
"""

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode

from eve_tpu_torch.kernels import build

# Activations the kernel folds in, by name, and their codes in csrc.
ACTS = {'none': 0, 'relu': 1, 'leaky': 2}
# bf16 values in a 16-byte vector (csrc).
VEC = 8

# The NHWC kernel: its channel tiles, largest first; the CTAs of a cluster,
# the widest tile a cluster splits, the rows of a TMA box and the boxes of
# a slab at most; the bytes of a CTA's slab it aims at (a few CTAs an SM)
# and takes at most (csrc).
NHWC_TILES = (256, 128, 64, 32, 16, 8)
MAX_CLUSTER = 8
MAX_CLUSTER_TILE = 32
MAX_BOX_ROWS = 256
MAX_BOXES = 40
SLAB_BYTES = 64 * 1024
MAX_SLAB_BYTES = 200 * 1024

_SIGNATURES = {
    'eve_instance_norm': (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p),
    'eve_instance_norm_nhwc': (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p),
}

LAUNCHES = {'instance_norm': 0}
_launches_lock = threading.Lock()


def reset_launch_counts():
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name):
    with _launches_lock:
        LAUNCHES[name] += 1


def _library():
    return build.load_library('norm_kernels', _SIGNATURES)


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def nhwc_launch(c, hw):
    """``(tile, cluster, box_rows, boxes)`` of the NHWC kernel over samples
    of ``hw`` rows of ``c`` channels, or None where it takes no such shape
    (``c`` not a multiple of 8, a 1x1 map, a tile's rows beyond what a
    cluster holds).

    A CTA a (sample, tile) where a tile of at least 32 channels (64-byte
    rows; the whole width if narrower) fits ``SLAB_BYTES``: the widest such
    tile. Else the rows of a 32-channel tile (or the whole width) split
    over the fewest CTAs of a cluster (at most ``MAX_CLUSTER``) that keep
    each slab near ``SLAB_BYTES`` (at most ``MAX_CLUSTER_TILE`` channels:
    the kernel's slots for the cluster's partials): on the card a cluster
    costs a tenth to a fifth of the rate (its CTAs wait at a barrier for
    the slowest), and rows under 64 bytes more. A slab loads as
    ``boxes`` TMA boxes (at most ``MAX_BOXES``) of ``box_rows`` rows (a
    multiple of 8, at most ``MAX_BOX_ROWS``).
    """
    if c % VEC or hw < 2:
        return None
    tiles = [t for t in NHWC_TILES if c % t == 0]
    narrow = next(t for t in tiles if t <= MAX_CLUSTER_TILE)
    alone = [t for t in tiles if t >= narrow and hw * t * 2 <= SLAB_BYTES]
    tile = alone[0] if alone else narrow
    cluster = min(MAX_CLUSTER, _cdiv(hw * tile * 2, SLAB_BYTES))
    rows = _cdiv(hw, cluster)
    boxes = _cdiv(rows, MAX_BOX_ROWS)
    box_rows = 8 * _cdiv(rows, 8 * boxes)
    rows = box_rows * boxes
    if rows * tile * 2 > MAX_SLAB_BYTES or boxes > MAX_BOXES:
        return None
    return tile, _cdiv(hw, rows), box_rows, boxes


def layout(x):
    """The layout the kernel reads ``x`` in: 'nhwc' (a channels-last
    (N, C, H, W) tensor that ``nhwc_launch`` tiles: the NHWC kernel, and the
    output channels-last too) or 'nchw' (anything else: the general kernel
    on ``x`` made contiguous, and a contiguous output)."""
    # Plain ints: a traced shape (a fake tensor's) specialises to its value.
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and nhwc_launch(int(x.shape[1]),
                            int(x.shape[2] * x.shape[3])) is not None:
        return 'nhwc'
    return 'nchw'


def out_format(x):
    """The memory format of the op's output on ``x``."""
    return (torch.channels_last if layout(x) == 'nhwc'
            else torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def mean_factor(planes, hw):
    """The factor PyTorch's CUDA mean over ``hw`` of ``planes * hw`` values
    multiplies a sum by: float32(planes) / float32(planes * hw)."""
    return float(np.float32(planes) / np.float32(planes * hw))


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError('%s kernel launch failed: cudaError %d'
                           % (name, err))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def activate(y, act, slope):
    """``act`` ('none', 'relu' or 'leaky' with ``slope``) applied to ``y``."""
    if act == 'relu':
        return F.relu(y)
    if act == 'leaky':
        return F.leaky_relu(y, slope)
    return y


def plain_scale_shift(x, weight, bias, eps):
    """Each plane's ``scale`` and ``shift`` in ``x``'s type, (..., C, 1, 1):
    float32 statistics (``E[x^2] - E[x]^2``, clamped at 0) with the affine
    weight and bias folded in, then cast."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    ex2 = (xf * xf).mean(dim=(-2, -1), keepdim=True)
    scale = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + eps)
    if weight is not None:
        scale = scale * weight[:, None, None]
    shift = -mean * scale
    if bias is not None:
        shift = shift + bias[:, None, None]
    return scale.to(x.dtype), shift.to(x.dtype)


def instance_norm_plain(x, weight, bias, eps, act, slope):
    """(N, C, H, W) -> the same: the one-pass instance norm of a bf16 input,
    then ``act``; the output in ``x``'s layout, as PyTorch's elementwise
    operations keep it.

    ``x * scale + shift`` in ``x``'s type, with ``plain_scale_shift``'s
    scale and shift. A 1x1 map gives 0, then the bias.
    """
    if x.shape[-2] * x.shape[-1] == 1:
        y = torch.zeros_like(x)
        if bias is not None:
            y = y + bias.to(x.dtype)[:, None, None]
        return activate(y, act, slope)
    scale, shift = plain_scale_shift(x, weight, bias, eps)
    return activate(x * scale + shift, act, slope)


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

@torch.library.custom_op('eve_tpu_torch::instance_norm', mutates_args=(),
                         device_types='cpu')
def _norm_op(x: torch.Tensor, weight: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], eps: float, act: str,
             slope: float) -> torch.Tensor:
    """The CPU implementation: the plain version, in the layout the CUDA
    implementation gives."""
    return instance_norm_plain(x, weight, bias, eps, act, slope).contiguous(
        memory_format=out_format(x))


def _parameter(t, c, x, what):
    if t is None:
        return None
    if t.device != x.device or tuple(t.shape) != (c,):
        raise ValueError('instance_norm takes a (%d,) %s on %s, got %s on %s'
                         % (c, what, x.device, tuple(t.shape), t.device))
    return t.float().contiguous()


@_norm_op.register_kernel('cuda')
def _norm_cuda(x, weight, bias, eps, act, slope):
    """The CUDA implementation: one launch of the kernel that ``layout``
    picks."""
    if x.dtype != torch.bfloat16:
        raise ValueError('the instance_norm kernel takes bfloat16, got %s'
                         % x.dtype)
    if x.ndim < 3:
        raise ValueError('instance_norm takes (..., C, H, W), got %s'
                         % (tuple(x.shape),))
    if act not in ACTS:
        raise ValueError('instance_norm act %r is none of %s'
                         % (act, sorted(ACTS)))
    form = layout(x)
    if form == 'nchw':
        x = x.contiguous()
    elif x.data_ptr() % 16:
        # TMA needs a 16-byte aligned base.
        x = x.clone(memory_format=torch.channels_last)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    c = x.shape[-3]
    hw = x.shape[-2] * x.shape[-1]
    planes = x.numel() // hw
    if planes > 2 ** 31 - 1 or hw > 2 ** 31 - 1:
        raise ValueError('instance_norm takes under 2^31 planes of under '
                         '2^31 values, got %d of %d' % (planes, hw))
    weight = _parameter(weight, c, x, 'weight')
    bias = _parameter(bias, c, x, 'bias')
    pointers = (x.data_ptr(), out.data_ptr(),
                None if weight is None else weight.data_ptr(),
                None if bias is None else bias.data_ptr())
    rest = (mean_factor(planes, hw), float(eps), ACTS[act], float(slope),
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if form == 'nhwc':
        err = _library().eve_instance_norm_nhwc(
            *pointers, x.shape[0], c, hw, *nhwc_launch(c, hw), *rest)
    else:
        err = _library().eve_instance_norm(*pointers, planes, c, hw, *rest)
    _check_launch(err, 'instance_norm')
    _count_launch('instance_norm')
    return out


@_norm_op.register_fake
def _norm_fake(x, weight, bias, eps, act, slope):
    return torch.empty_like(x, memory_format=out_format(x))


def _norm_setup_context(ctx, inputs, output):
    x, weight, bias, eps, act, slope = inputs
    ctx.save_for_backward(x, weight, bias, output)
    ctx.args = (eps, act, slope)


def _sum_to(g, shape):
    """``g`` summed to ``shape`` as autograd sums a broadcast gradient
    (``at::sum_to``)."""
    lead = g.ndim - len(shape)
    dims = list(range(lead)) + [i for i in range(lead, g.ndim)
                                if shape[i - lead] == 1 and g.shape[i] != 1]
    return g.sum(dims, keepdim=True).view(shape) if dims else g


def plain_backward(x, weight, bias, out, eps, act, slope, grad):
    """``(grad x, grad weight, grad bias)`` of ``instance_norm_plain`` at
    ``x`` (its output ``out``, a map of more than one value), to ``grad``:
    the operations autograd runs through the plain version, in its order,
    so the gradients are autograd's bitwise, without recording a graph.
    The gradient to the weight or the bias is None where that is."""
    hw = x.shape[-2] * x.shape[-1]
    channel = (x.shape[-3], 1, 1)
    # The plain version's statistics.
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    ex2 = (xf * xf).mean(dim=(-2, -1), keepdim=True)
    var = ex2 - mean * mean
    r = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    w = None if weight is None else weight[:, None, None]
    scale = r if w is None else r * w
    neg_mean = -mean
    # The apply and the activation.
    if act == 'relu':
        grad = torch.ops.aten.threshold_backward(grad, out, 0)
    elif act == 'leaky':
        # out > 0 exactly where its input is.
        grad = torch.ops.aten.leaky_relu_backward(grad, out, slope, False)
    stat = tuple(mean.shape)
    g_shift = _sum_to(grad, stat).float()
    g_x = grad * scale.to(x.dtype)
    g_scale = _sum_to(grad * x, stat).float()
    g_bias = None if bias is None else _sum_to(g_shift, channel).view(-1)
    g_neg_mean = g_shift * scale
    g_scale = g_scale + g_shift * neg_mean
    g_mean = g_neg_mean.neg()
    g_weight = None
    if w is not None:
        g_weight = _sum_to(g_scale * r, channel).view(-1)
        g_scale = g_scale * w
    # The statistics.
    g_var = -0.5 * g_scale * r.pow(3)
    zero = torch.zeros((), dtype=g_var.dtype, device=g_var.device)
    g_var = torch.where(var >= 0.0, g_var, zero)
    g_mm = g_var.neg()
    g_mean = g_mean + g_mm * mean
    g_mean = g_mean + g_mm * mean
    g_sq = g_var.expand(x.shape) / hw
    g_xf = g_sq * xf + g_sq * xf
    g_xf = g_xf + g_mean.expand(x.shape) / hw
    return g_x + g_xf.to(x.dtype), g_weight, g_bias


def _norm_backward(ctx, grad):
    """By ``plain_backward`` (there is no backward kernel), to the input and
    to the weight and bias where given; a 1x1 map through the plain
    version, recomputed from the saved input."""
    x, weight, bias, out = ctx.saved_tensors
    if x.shape[-2] * x.shape[-1] > 1:
        return plain_backward(x, weight, bias, out, *ctx.args, grad) + (
            None, None, None)
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in (x, weight, bias)]
    given = [t for t in leaves if t is not None]
    with torch.enable_grad():
        y = instance_norm_plain(*leaves, *ctx.args)
        if y.requires_grad:
            grads = iter(torch.autograd.grad(
                y, given, grad, allow_unused=True, materialize_grads=True))
        else:  # a 1x1 map without a bias: a constant output
            grads = iter([torch.zeros_like(t) for t in given])
    return tuple(None if t is None else next(grads) for t in leaves) + (
        None, None, None)


_norm_op.register_autograd(_norm_backward, setup_context=_norm_setup_context)


def eager(*tensors):
    """Whether a call on ``tensors`` (None allowed) runs eagerly on real
    tensors with nothing to record: no ``torch.compile`` or
    ``torch.export`` tracing, no dispatch mode, plain tensors or
    parameters, and no autograd graph (grad off, or no tensor requiring
    it)."""
    if torch.compiler.is_compiling() or \
            _get_current_dispatch_mode() is not None:
        return False
    grad = torch.is_grad_enabled()
    return all(t is None or (type(t) in (torch.Tensor, torch.nn.Parameter)
                             and not (grad and t.requires_grad))
               for t in tensors)


def instance_norm(x, weight=None, bias=None, eps=1e-5, act='none',
                  slope=0.0):
    """(N, C, H, W) -> the same: the ``eve_tpu_torch::instance_norm`` op,
    one kernel launch on a bf16 CUDA tensor, the plain version on a CPU
    tensor; channels-last in, channels-last out (``layout``). Where
    ``eager`` holds, a CUDA tensor goes to the op's CUDA implementation
    without the op's dispatch: the same launch.

    ``weight`` and ``bias``: (C,) tensors on the same device, or None;
    ``act``: 'none', 'relu' or 'leaky' (``slope``: its negative slope in
    ``x``'s type).
    """
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('instance_norm takes a CPU or CUDA tensor, got %s'
                         % x.device)
    if x.is_cuda and eager(x, weight, bias):
        return _norm_cuda(x, weight, bias, float(eps), act, float(slope))
    return _norm_op(x, weight, bias, float(eps), act, float(slope))
