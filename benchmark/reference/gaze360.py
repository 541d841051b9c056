"""Plain PyTorch Gaze360: the yardstick that decides ``correct`` in the
face cells.

Gaze360 (Kellnhofer et al., ICCV 2019; github.com/erkil1452/gaze360,
``code/model.py`` ``GazeLSTM``) written from its published layers as
functions over a dict of weights keyed by its state-dict names, in float32
with no custom kernels, caches or batching tricks, in its literal form:
each frame's output reads a window of 7 frames, t-3 .. t+3 (indices held
to the clip), and every window's 7 frames go through the backbone, so a
clip of T frames runs the backbone 7 T times.

- Backbone (``base_model``): ImageNet-normalised 224x224 RGB, torchvision's
  ResNet-18 with BatchNorm as it evaluates (the running statistics, eps
  1e-5, written out per channel), the global average pool, ``fc1`` 512 ->
  1000, ReLU, ``fc2`` 1000 -> 256.
- Temporal (``lstm``): two layers of a bidirectional LSTM over the
  window's 7 features, written out (gates i, f, g, o; each direction from
  zero states; layer 2 reads layer 1's ``[h_fwd; h_bwd]``); the top
  layer's output at the middle step.
- Head (``last_layer``, 512 -> 3): yaw pi * tanh, pitch pi/2 * tanh and
  one spread pi * sigmoid; the (pitch, yaw) gaze from the face's origin
  and rotation meets the screen (``reference.eve.pog_px``).

``quant`` (optional) rounds the operands of the convolutions, which a
bfloat16 program runs in its lower compute type: the control of
``correct``. Nothing here imports the measured program.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference import eve as ref

WINDOW = 7
FEATURES = 256
STAGES = (64, 128, 256, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


# ----------------------------------------------------------------------
# Parameters: (name, shape, kind), in the published state-dict names
# ----------------------------------------------------------------------

def _bn(name, c):
    """A norm's affine terms and running statistics (the variances near 1
    and positive, the means near 0)."""
    return [(name + '.weight', (c,), 'norm_weight'),
            (name + '.bias', (c,), 'norm_bias'),
            (name + '.running_mean', (c,), 'norm_bias'),
            (name + '.running_var', (c,), 'norm_weight')]


def backbone_specs():
    pre = 'base_model.'
    p = ref._conv(pre + 'conv1', 64, 3, 7, bias=False) + _bn(pre + 'bn1', 64)
    cin = 64
    for s, cout in enumerate(STAGES):
        for b in range(2):
            blk = pre + 'layer%d.%d.' % (s + 1, b)
            first = cin if b == 0 else cout
            p += ref._conv(blk + 'conv1', cout, first, 3, bias=False)
            p += _bn(blk + 'bn1', cout)
            p += ref._conv(blk + 'conv2', cout, cout, 3, bias=False)
            p += _bn(blk + 'bn2', cout)
            if b == 0 and s > 0:
                p += ref._conv(blk + 'downsample.0', cout, first, 1,
                               bias=False)
                p += _bn(blk + 'downsample.1', cout)
        cin = cout
    p += ref._linear(pre + 'fc1', 1000, 512)
    p += ref._linear(pre + 'fc2', FEATURES, 1000)
    return p


def lstm_specs():
    p = []
    for layer in range(2):
        for suffix in ('', '_reverse'):
            tag = '_l%d%s' % (layer, suffix)
            n_in = FEATURES if layer == 0 else 2 * FEATURES
            p += [('lstm.weight_ih' + tag, (4 * FEATURES, n_in), 'rnn'),
                  ('lstm.weight_hh' + tag, (4 * FEATURES, FEATURES), 'rnn'),
                  ('lstm.bias_ih' + tag, (4 * FEATURES,), 'rnn'),
                  ('lstm.bias_hh' + tag, (4 * FEATURES,), 'rnn')]
    return p


def param_specs(cfg):
    """Every parameter of Gaze360: ``[(name, shape, kind)]``."""
    if cfg.get('gaze_net') != 'gaze360':
        raise ValueError('the Gaze360 reference is for gaze_net gaze360, '
                         'not %r' % (cfg.get('gaze_net'),))
    return (backbone_specs() + lstm_specs()
            + ref._linear('last_layer', 3, 2 * FEATURES))


def norm_buffers(specs):
    """The batch-count buffer beside each norm's statistics, which torch's
    state dict carries and the model ignores in evaluation:
    ``{name: 0-dim int64 zero}``."""
    return {name[:-len('running_mean')] + 'num_batches_tracked':
            torch.zeros((), dtype=torch.long)
            for name, _, _ in specs if name.endswith('.running_mean')}


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------

def _ident(t):
    return t


def batch_norm(w, name, x, calibrate=False):
    """Eval BatchNorm: ``(x - mean) / sqrt(var + eps) * weight + bias``,
    per channel. ``calibrate`` first sets the running statistics in ``w``
    to ``x``'s own (per channel, the variance biased)."""
    if calibrate:
        w[name + '.running_mean'] = x.mean(dim=(0, 2, 3))
        w[name + '.running_var'] = x.var(dim=(0, 2, 3), unbiased=False)
    scale = w[name + '.weight'] / torch.sqrt(w[name + '.running_var']
                                             + BN_EPS)
    shift = w[name + '.bias'] - w[name + '.running_mean'] * scale
    return torch.addcmul(shift[:, None, None], x, scale[:, None, None])


def normalise(frames_u8):
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32, ImageNet's mean and
    std."""
    x = frames_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def backbone(w, x, quant=_ident, calibrate=False):
    """(N, 3, H, W) normalised frames -> (N, 256) features (``calibrate``:
    see ``calibrated``)."""
    pre = 'base_model.'

    def batch_norm(w, name, x):
        return globals()['batch_norm'](w, name, x, calibrate)

    x = F.relu(batch_norm(w, pre + 'bn1',
                          ref.conv(w, pre + 'conv1', x, 2, 3, quant)))
    x = F.max_pool2d(x, 3, 2, 1)
    for s in range(4):
        for b in range(2):
            blk = pre + 'layer%d.%d.' % (s + 1, b)
            stride = 2 if (b == 0 and s > 0) else 1
            if b == 0 and s > 0:
                identity = batch_norm(w, blk + 'downsample.1', ref.conv(
                    w, blk + 'downsample.0', x, stride, 0, quant))
            else:
                identity = x
            out = F.relu(batch_norm(w, blk + 'bn1', ref.conv(
                w, blk + 'conv1', x, stride, 1, quant)))
            out = batch_norm(w, blk + 'bn2',
                             ref.conv(w, blk + 'conv2', out, 1, 1, quant))
            x = F.relu(out + identity)
    pooled = x.mean(dim=(-2, -1))
    return ref.linear(w, pre + 'fc2',
                      F.relu(ref.linear(w, pre + 'fc1', pooled)))


def calibrated(w, frames_u8):
    """``w`` with each norm's running statistics those of its input over
    the (N, H, W, 3) uint8 ``frames_u8``, norm by norm in the network's
    order: the statistics a trained network's norms hold for its data."""
    w = dict(w)
    with torch.no_grad():
        backbone(w, normalise(frames_u8), calibrate=True)
    return w


def lstm_direction(w, tag, x):
    """One direction of one layer over (N, L, F) inputs from zero states:
    (N, L, 256), in the inputs' order (``_reverse`` runs from the last
    step to the first)."""
    n, steps, _ = x.shape
    h = x.new_zeros(n, FEATURES)
    c = x.new_zeros(n, FEATURES)
    order = range(steps - 1, -1, -1) if tag.endswith('_reverse') \
        else range(steps)
    out = [None] * steps
    for t in order:
        gates = (F.linear(x[:, t], w['lstm.weight_ih' + tag],
                          w['lstm.bias_ih' + tag])
                 + F.linear(h, w['lstm.weight_hh' + tag],
                            w['lstm.bias_hh' + tag]))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, dim=1)


def temporal(w, windows):
    """(N, 7, 256) window features -> (N, 3) head outputs."""
    x = windows
    for layer in range(2):
        x = torch.cat([lstm_direction(w, '_l%d' % layer, x),
                       lstm_direction(w, '_l%d_reverse' % layer, x)],
                      dim=-1)
    return ref.linear(w, 'last_layer', x[:, WINDOW // 2])


def window_frame(t, k, T):
    """The frame at place ``k`` (0..6) of frame ``t``'s window."""
    return min(max(t + k - WINDOW // 2, 0), T - 1)


# ----------------------------------------------------------------------
# The whole model
# ----------------------------------------------------------------------

def forward(w, cfg, batch, quant=_ident):
    """Gaze360 over a (B, T, ...) batch of tensors (``frame`` (B, T, H, W,
    3) uint8 faces, ``face_o``, ``face_R`` and the camera's), each
    window's 7 frames through the backbone: ``g_initial`` (B, T, 2)
    (pitch, yaw), ``gaze_spread`` (B, T) and ``PoG_px_initial`` (B, T,
    2)."""
    frames = batch['frame']
    B, T = frames.shape[:2]
    places = []
    for k in range(WINDOW):
        # Place k of every window: its frames, gathered, normalised and
        # run through the backbone.
        idx = torch.tensor([window_frame(t, k, T) for t in range(T)],
                           device=frames.device)
        x = normalise(frames[:, idx].reshape((B * T,) + frames.shape[2:]))
        places.append(backbone(w, x, quant))
    o = temporal(w, torch.stack(places, dim=1)).reshape(B, T, 3)
    g = torch.stack([0.5 * math.pi * torch.tanh(o[..., 1]),
                     math.pi * torch.tanh(o[..., 0])], dim=-1)
    pog = ref.pog_px(batch['face_o'], g, batch['face_R'],
                     batch['inv_camera_transformation'],
                     batch['pixels_per_millimeter'])
    return {'g_initial': g, 'gaze_spread': math.pi * torch.sigmoid(o[..., 2]),
            'PoG_px_initial': pog}
