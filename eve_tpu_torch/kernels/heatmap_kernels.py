"""Heatmap render and soft-argmax: CUDA kernels, their plain versions, wrappers.

The two TPU kernels of eve_tpu (``eve_tpu/kernels/heatmap_kernels.py``:
``pallas_make_heatmaps`` and ``pallas_soft_argmax``) become the hand-written
Hopper kernels in ``eve_tpu_torch/csrc/heatmap_kernels.cu``; the source there
says what bounds each one on the card and what its design does about it.

Beside each kernel, in this module:

- the plain PyTorch version (``make_heatmaps_plain`` and its multi-sigma
  form ``make_heatmaps_multi_plain``, ``soft_argmax_plain``), which the CPU
  runs and which the kernels are held against on the card;
- a ``torch.library`` custom op (``eve_tpu_torch::render_heatmaps``,
  ``eve_tpu_torch::soft_argmax``): its CPU implementation is the plain
  version, its CUDA implementation launches the kernel or raises (there is
  no fallback), its fake implementation gives the output's shape, so that
  ``torch.export`` traces the op as one node, and its backward
  differentiates the plain formula, as eve_tpu's ``custom_vjp`` does
  (eve_tpu has no backward kernel, so neither has the port);
- the wrapper (``render_heatmaps``, ``soft_argmax``), which calls the op;
- a launch count (``LAUNCHES``), bumped once per kernel launch and nowhere
  else.

``launch_empty_kernel`` launches a kernel that does nothing, for timing the
launch floor beside the two kernels; it is on no model path.
"""

import ctypes
import threading
from typing import List, Optional

import torch

from eve_tpu_torch.kernels import build

HEATMAP_H = 72
HEATMAP_W = 128
SCREEN_SIZE = (1920.0, 1080.0)
SOFTARGMAX_BETA = 100.0

# Launch shapes (csrc: 256-thread CTAs). The render spreads its rows over
# about this many CTAs an SM; the soft-argmax runs a cluster of 1-8 CTAs a
# map.
THREADS = 256
RENDER_CTAS_PER_SM = 2
SOFT_ARGMAX_CLUSTERS = (1, 2, 4, 8)
# Sigmas one render launch takes.
MAX_SIGMAS = 4
# Widest soft-argmax map: one row fits a 32 KB shared-memory stage (csrc).
SOFT_ARGMAX_MAX_WIDTH = 8192

_SIGNATURES = {
    'eve_render_heatmaps': (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    'eve_soft_argmax': (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    'eve_empty_kernel': (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
}

LAUNCHES = {'render_heatmaps': 0, 'soft_argmax': 0}
_launches_lock = threading.Lock()


def reset_launch_counts():
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name):
    with _launches_lock:
        LAUNCHES[name] += 1


def _library():
    return build.load_library('heatmap_kernels', _SIGNATURES)


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError('%s kernel launch failed: cudaError %d'
                           % (name, err))


def _require_cpu_or_cuda(x, name):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('%s takes a CPU or CUDA tensor, got %s'
                         % (name, x.device))


def _require_aligned(x, name):
    if x.data_ptr() % 16:
        raise ValueError('%s needs a 16-byte aligned tensor' % name)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def render_rows(s, n, h, sms):
    """Rows of one map a render CTA takes, for ``s`` sigmas of ``n`` maps.

    About ``RENDER_CTAS_PER_SM`` CTAs an SM: the map's rows split into
    ``round(RENDER_CTAS_PER_SM * sms / (s * n))`` blocks, 1 to ``h``.
    """
    blocks = max(1, min(h, int(RENDER_CTAS_PER_SM * sms / (s * n) + 0.5)))
    return -(-h // blocks)


def soft_argmax_cluster_size(n, quads, sms):
    """CTAs a map for the soft-argmax of ``n`` maps of ``quads`` float4s.

    The smallest cluster with ``n * C >= sms``, at most 8, and at most one
    CTA per ``THREADS`` quads so that every thread has a quad to read.
    """
    c = next((c for c in SOFT_ARGMAX_CLUSTERS if n * c >= sms),
             SOFT_ARGMAX_CLUSTERS[-1])
    while c > 1 and quads < c * THREADS:
        c //= 2
    return c


# ---------------------------------------------------------------------------
# Render
# ---------------------------------------------------------------------------

def make_heatmaps_plain(centres_px, sigma,
                        heatmap_size=(HEATMAP_W, HEATMAP_H),
                        actual_screen_size=SCREEN_SIZE):
    """(..., 2) screen-px centres -> (..., H, W) Gaussian heatmaps.

    The centre is scaled from the screen to the heatmap grid; each value is
    exp(-0.5/sigma^2 * ((x-cx)^2 + (y-cy)^2)) + 1e-8.
    """
    w, h = heatmap_size
    xs = torch.arange(w, dtype=torch.float32, device=centres_px.device)
    ys = torch.arange(h, dtype=torch.float32, device=centres_px.device)
    alpha = -0.5 / (float(sigma) ** 2)
    cx = (w / float(actual_screen_size[0])) * centres_px[..., 0]
    cy = (h / float(actual_screen_size[1])) * centres_px[..., 1]
    dx2 = (xs - cx.unsqueeze(-1)) ** 2                   # (..., W)
    dy2 = (ys - cy.unsqueeze(-1)) ** 2                   # (..., H)
    hm = torch.exp(alpha * (dy2.unsqueeze(-1) + dx2.unsqueeze(-2)))
    return hm + 1e-8


def make_heatmaps_multi_plain(centres_px, sigmas, multiplier=None,
                              heatmap_size=(HEATMAP_W, HEATMAP_H),
                              actual_screen_size=SCREEN_SIZE):
    """(..., 2) centres -> (S, ..., H, W): one map per sigma and centre.

    With ``multiplier`` (shape ``centres_px.shape[:-1]``) each map is
    multiplied by its centre's entry, as a validity mask is applied.
    """
    maps = torch.stack([make_heatmaps_plain(centres_px, s, heatmap_size,
                                            actual_screen_size)
                        for s in sigmas])
    if multiplier is not None:
        maps = maps * multiplier[..., None, None]
    return maps


@torch.library.custom_op('eve_tpu_torch::render_heatmaps', mutates_args=(),
                         device_types='cpu')
def _render_op(centres_px: torch.Tensor, sigmas: List[float],
               multiplier: Optional[torch.Tensor], heatmap_size: List[int],
               actual_screen_size: List[float]) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    return make_heatmaps_multi_plain(centres_px, sigmas, multiplier,
                                     heatmap_size, actual_screen_size)


@_render_op.register_kernel('cuda')
def _render_cuda(centres_px, sigmas, multiplier, heatmap_size,
                 actual_screen_size):
    """The CUDA implementation: one launch of the render kernel."""
    w, h = heatmap_size
    if not 1 <= len(sigmas) <= MAX_SIGMAS:
        raise ValueError('render_heatmaps takes 1 to %d sigmas, got %d'
                         % (MAX_SIGMAS, len(sigmas)))
    if centres_px.ndim != 2 or centres_px.shape[1] != 2:
        raise ValueError('render_heatmaps takes (N, 2) centres, got %s'
                         % (tuple(centres_px.shape),))
    if centres_px.dtype != torch.float32 or not centres_px.is_contiguous():
        raise ValueError('render_heatmaps takes contiguous float32 centres, '
                         'got %s' % centres_px.dtype)
    n = centres_px.shape[0]
    if multiplier is not None and (
            multiplier.device != centres_px.device
            or multiplier.dtype != torch.float32
            or tuple(multiplier.shape) != (n,)
            or not multiplier.is_contiguous()):
        raise ValueError('render_heatmaps takes a contiguous (%d,) float32 '
                         'multiplier on %s, got %s %s on %s'
                         % (n, centres_px.device, tuple(multiplier.shape),
                            multiplier.dtype, multiplier.device))
    if w % 4:
        raise ValueError('render_heatmaps needs a width divisible by 4, '
                         'got %d' % w)
    out = torch.empty((len(sigmas), n, h, w), dtype=torch.float32,
                      device=centres_px.device)
    if n == 0:
        return out
    alphas = [-0.5 / s ** 2 for s in sigmas]
    alphas += [0.0] * (MAX_SIGMAS - len(alphas))
    rows = render_rows(len(sigmas), n, h, _sm_count(centres_px.device))
    err = _library().eve_render_heatmaps(
        centres_px.data_ptr(),
        None if multiplier is None else multiplier.data_ptr(),
        out.data_ptr(), n, len(sigmas), h, w, *alphas,
        w / float(actual_screen_size[0]), h / float(actual_screen_size[1]),
        rows, centres_px.device.index, _stream(centres_px.device))
    _check_launch(err, 'render_heatmaps')
    _count_launch('render_heatmaps')
    return out


@_render_op.register_fake
def _render_fake(centres_px, sigmas, multiplier, heatmap_size,
                 actual_screen_size):
    w, h = heatmap_size
    return centres_px.new_empty(
        (len(sigmas),) + tuple(centres_px.shape[:-1]) + (h, w),
        dtype=torch.float32)


def _render_setup_context(ctx, inputs, output):
    centres_px, sigmas, multiplier, heatmap_size, actual_screen_size = inputs
    ctx.save_for_backward(centres_px, multiplier)
    ctx.args = (tuple(sigmas), tuple(heatmap_size), tuple(actual_screen_size))


def _render_backward(ctx, grad):
    """To the centres through the plain formula, as eve_tpu's
    ``custom_vjp`` differentiates its jnp formula (there is no backward
    kernel). The multiplier is a mask: no gradient flows to it. In training
    with a frozen EyeNet the centres carry no gradient, so this runs only
    when EyeNet trains."""
    centres_px, multiplier = ctx.saved_tensors
    sigmas, heatmap_size, actual_screen_size = ctx.args
    with torch.enable_grad():
        c = centres_px.detach().requires_grad_(True)
        maps = make_heatmaps_multi_plain(c, sigmas, multiplier, heatmap_size,
                                         actual_screen_size)
        (g,) = torch.autograd.grad(maps, c, grad)
    return g, None, None, None, None


_render_op.register_autograd(_render_backward,
                             setup_context=_render_setup_context)


def render_heatmaps(centres_px, sigmas, multiplier=None,
                    heatmap_size=(HEATMAP_W, HEATMAP_H),
                    actual_screen_size=SCREEN_SIZE):
    """(N, 2) float32 centres -> (S, N, H, W) float32 maps: the
    ``eve_tpu_torch::render_heatmaps`` op, one kernel launch on a CUDA
    tensor.

    ``sigmas`` is a sequence of 1 to ``MAX_SIGMAS`` sigmas; ``multiplier``,
    if given, an (N,) float32 tensor on the same device.
    """
    _require_cpu_or_cuda(centres_px, 'render_heatmaps')
    return _render_op(centres_px, [float(s) for s in sigmas], multiplier,
                      [int(v) for v in heatmap_size],
                      [float(v) for v in actual_screen_size])


# ---------------------------------------------------------------------------
# Soft-argmax
# ---------------------------------------------------------------------------

def soft_argmax_plain(heatmaps, heatmap_size=(HEATMAP_W, HEATMAP_H),
                      actual_screen_size=SCREEN_SIZE, beta=SOFTARGMAX_BETA):
    """(..., H, W) heatmaps -> (..., 2) screen px, clamped to the screen.

    A beta softmax over the grid, its expectation against linspace(0, 1, W)
    x linspace(0, 1, H), scaled to the screen; computed in float32.
    """
    w, h = heatmap_size
    x = heatmaps.float()
    ref_xs = torch.linspace(0.0, 1.0, w, dtype=torch.float32, device=x.device)
    ref_ys = torch.linspace(0.0, 1.0, h, dtype=torch.float32, device=x.device)
    flat = x.reshape(x.shape[:-2] + (h * w,))
    p = torch.softmax(beta * flat, dim=-1).reshape(x.shape)
    lmrk_x = torch.sum(p * ref_xs, dim=(-2, -1))
    lmrk_y = torch.sum(p * ref_ys.unsqueeze(-1), dim=(-2, -1))
    sw, sh = float(actual_screen_size[0]), float(actual_screen_size[1])
    return torch.stack([
        torch.clamp(sw * lmrk_x, 0.0, sw),
        torch.clamp(sh * lmrk_y, 0.0, sh),
    ], dim=-1)


@torch.library.custom_op('eve_tpu_torch::soft_argmax', mutates_args=(),
                         device_types='cpu')
def _soft_argmax_op(heatmaps: torch.Tensor, heatmap_size: List[int],
                    actual_screen_size: List[float],
                    beta: float) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    return soft_argmax_plain(heatmaps, heatmap_size, actual_screen_size, beta)


@_soft_argmax_op.register_kernel('cuda')
def _soft_argmax_cuda(heatmaps, heatmap_size, actual_screen_size, beta):
    """The CUDA implementation: one launch of the soft-argmax kernel."""
    w, h = heatmap_size
    if heatmaps.ndim != 3 or tuple(heatmaps.shape[1:]) != (h, w):
        raise ValueError('soft_argmax takes (N, %d, %d) maps, got %s'
                         % (h, w, tuple(heatmaps.shape)))
    if heatmaps.dtype != torch.float32 or not heatmaps.is_contiguous():
        raise ValueError('soft_argmax takes contiguous float32 maps, got %s'
                         % heatmaps.dtype)
    if w % 4 or not 4 <= w <= SOFT_ARGMAX_MAX_WIDTH or h < 2:
        raise ValueError('soft_argmax kernel takes maps with W %% 4 == 0, '
                         '4 <= W <= %d and H >= 2, got %dx%d'
                         % (SOFT_ARGMAX_MAX_WIDTH, h, w))
    n = heatmaps.shape[0]
    out = torch.empty((n, 2), dtype=torch.float32, device=heatmaps.device)
    if n == 0:
        return out
    _require_aligned(heatmaps, 'soft_argmax')
    cluster = soft_argmax_cluster_size(n, h * w // 4,
                                       _sm_count(heatmaps.device))
    err = _library().eve_soft_argmax(
        heatmaps.data_ptr(), out.data_ptr(), n, h, w, float(beta),
        float(actual_screen_size[0]), float(actual_screen_size[1]), cluster,
        heatmaps.device.index, _stream(heatmaps.device))
    _check_launch(err, 'soft_argmax')
    _count_launch('soft_argmax')
    return out


@_soft_argmax_op.register_fake
def _soft_argmax_fake(heatmaps, heatmap_size, actual_screen_size, beta):
    return heatmaps.new_empty(tuple(heatmaps.shape[:-2]) + (2,),
                              dtype=torch.float32)


def _soft_argmax_setup_context(ctx, inputs, output):
    heatmaps, heatmap_size, actual_screen_size, beta = inputs
    ctx.save_for_backward(heatmaps)
    ctx.args = (tuple(heatmap_size), tuple(actual_screen_size), beta)


def _soft_argmax_backward(ctx, grad):
    """Through the plain formula, as eve_tpu's ``custom_vjp``
    differentiates its jnp formula (there is no backward kernel). On the
    training path this gradient feeds ``loss_mse_PoG_cm_final``."""
    (heatmaps,) = ctx.saved_tensors
    with torch.enable_grad():
        x = heatmaps.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(soft_argmax_plain(x, *ctx.args), x, grad)
    return g, None, None, None


_soft_argmax_op.register_autograd(_soft_argmax_backward,
                                  setup_context=_soft_argmax_setup_context)


def soft_argmax(heatmaps, heatmap_size=(HEATMAP_W, HEATMAP_H),
                actual_screen_size=SCREEN_SIZE, beta=SOFTARGMAX_BETA):
    """(N, H, W) heatmaps -> (N, 2) float32 screen px: the
    ``eve_tpu_torch::soft_argmax`` op, one kernel launch on a CUDA tensor.

    bfloat16 and float16 maps are cast to float32 here; the kernel takes
    contiguous float32 maps of any height >= 2 and widths W % 4 == 0 up to
    ``SOFT_ARGMAX_MAX_WIDTH``.
    """
    _require_cpu_or_cuda(heatmaps, 'soft_argmax')
    if heatmaps.dtype in (torch.bfloat16, torch.float16):
        heatmaps = heatmaps.float()
    return _soft_argmax_op(heatmaps, [int(v) for v in heatmap_size],
                           [float(v) for v in actual_screen_size],
                           float(beta))


# ---------------------------------------------------------------------------
# Launch floor
# ---------------------------------------------------------------------------

def launch_empty_kernel(ctas, cluster, device):
    """Launch ``ctas`` CTAs of an empty kernel in clusters of ``cluster`` on
    ``device`` (a ``torch.device`` with an index)."""
    _check_launch(_library().eve_empty_kernel(ctas, cluster, device.index,
                                              _stream(device)),
                  'empty')
