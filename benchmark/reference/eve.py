"""Plain PyTorch EVE: the yardstick that decides ``correct``.

EVE (Park et al., ECCV 2020; github.com/swook/EVE) written from its
published architecture as functions over a dict of weights keyed by the
reference's state-dict names (which the measured program shares), in
float32 with no custom kernels, caches or batching tricks:

- EyeNet: ResNet-18 with affine-free instance norms on [-1, 1] eye
  patches, its 512 -> F ``fc``, the 2-D head pose appended, ``fc_common``
  (Linear, SELU, Linear), one GRU cell over time, the gaze head
  (pi/2 * tanh; last layer without bias) and the pupil head (ReLU).
- Geometry: each eye's gaze ray (from its origin, rotated by its head
  rotation, into screen coordinates through the inverse camera transform)
  meets the screen plane z = 0; the point of gaze (PoG) in px is the mean
  of the two eyes', clamped to the screen.
- RefineNet: the initial PoG rendered as a Gaussian heatmap, stacked under
  the screen frame, a five-level pyramid of pre-activation residual blocks
  with adaptive max-pooling down and bilinear resizing up, skip
  concatenations, a conv-LSTM bottleneck that (as in the released model)
  carries its state and passes its input on, and a sigmoid heatmap read
  back to px by a beta = 100 soft-argmax.

``quant`` (optional) rounds the operands of the forward's convolutions,
which a bfloat16 program runs in its lower compute type: the control of
``correct`` puts this reference in the program's place at a precision
below the configuration's. Nothing here imports the measured program.
"""

import math

import torch
import torch.nn.functional as F

LEVEL_CHANNELS = (16, 32, 64, 128, 256)
LEVEL_SHAPES = ((72, 128), (36, 64), (18, 32), (9, 16), (5, 8))
NUM_ENC_BLOCKS = (1, 2, 2, 2, 2)
SOFTARGMAX_BETA = 100.0
SCREEN_PX = (1920.0, 1080.0)


# ----------------------------------------------------------------------
# Parameters: (name, shape, kind), in the reference's state-dict names
# ----------------------------------------------------------------------

def _conv(name, o, i, k, bias=True):
    out = [(name + '.weight', (o, i, k, k), 'conv')]
    if bias:
        out.append((name + '.bias', (o,), 'conv_bias'))
    return out


def _linear(name, o, i, bias=True):
    out = [(name + '.weight', (o, i), 'linear')]
    if bias:
        out.append((name + '.bias', (o,), 'linear'))
    return out


def _norm(name, c):
    return [(name + '.weight', (c,), 'norm_weight'),
            (name + '.bias', (c,), 'norm_bias')]


def eye_net_specs(nf):
    p = _conv('eye_net.cnn_layers.conv1', 64, 3, 7, bias=False)
    cin = 64
    for s, cout in enumerate((64, 128, 256, 512)):
        for b in range(2):
            pre = 'eye_net.cnn_layers.layer%d.%d.' % (s + 1, b)
            first = cin if b == 0 else cout
            p += _conv(pre + 'conv1', cout, first, 3, bias=False)
            p += _conv(pre + 'conv2', cout, cout, 3, bias=False)
            if b == 0 and s > 0:
                p += _conv(pre + 'downsample.0', cout, first, 1, bias=False)
        cin = cout
    p += _linear('eye_net.cnn_layers.fc', nf, 512)
    p += _linear('eye_net.fc_common.0', nf, nf + 2)
    p += _linear('eye_net.fc_common.2', nf, nf)
    p += [('eye_net.rnn_cells.0.weight_ih', (3 * nf, nf), 'rnn'),
          ('eye_net.rnn_cells.0.weight_hh', (3 * nf, nf), 'rnn'),
          ('eye_net.rnn_cells.0.bias_ih', (3 * nf,), 'rnn'),
          ('eye_net.rnn_cells.0.bias_hh', (3 * nf,), 'rnn')]
    p += _linear('eye_net.fc_to_gaze.0', nf, nf)
    p += _linear('eye_net.fc_to_gaze.2', 2, nf, bias=False)
    p += _linear('eye_net.fc_to_pupil.0', nf, nf)
    p += _linear('eye_net.fc_to_pupil.2', 1, nf)
    return p


def _preact(pre, cin, cout):
    p = _norm(pre + 'layers.0', cin) + _conv(pre + 'layers.2', cout, cin, 3)
    p += _norm(pre + 'layers.3', cout) + _conv(pre + 'layers.5', cout, cout, 3)
    if cin != cout:
        p += _norm(pre + 'skip_layer.0', cin)
        p += _conv(pre + 'skip_layer.2', cout, cin, 1)
    return p


def _level_prefix(k):
    return 'refine_net.network.' + 'between_module.' * k


def refine_net_specs(nf, in_channels):
    p = _conv('refine_net.initial.0', 16, in_channels, 3)
    p += _norm('refine_net.initial.1', 16)
    p += _conv('refine_net.initial.3', 16, 16, 3)
    for k in range(5):
        pre = _level_prefix(k)
        out_c = LEVEL_CHANNELS[k + 1] if k < 4 else nf
        for j in range(NUM_ENC_BLOCKS[k]):
            p += _preact(pre + 'encoder_blocks.%d.' % j,
                         LEVEL_CHANNELS[k] if j == 0 else out_c, out_c)
        dec_out = LEVEL_CHANNELS[k] if k < 4 else LEVEL_CHANNELS[4]
        p += _preact(pre + 'decoder_blocks.0.', 2 * out_c, dec_out)
    p += _conv(_level_prefix(5) + 'rnn_cells.0.gates', 4 * nf, 2 * nf, 3)
    p += _conv('refine_net.final.0', 16, 16, 3)
    p += _conv('refine_net.final.2', 1, 16, 1)
    return p


def param_specs(cfg):
    """Every parameter of the configuration's model: ``[(name, shape,
    kind)]``. Only the configuration this benchmark runs is written down:
    a GRU EyeNet with head pose and, when enabled, a CLSTM RefineNet with
    skip connections and screen content."""
    written = {'eye_net_rnn_type': 'GRU', 'eye_net_rnn_num_cells': 1,
               'eye_net_use_rnn': True, 'eye_net_use_head_pose_input': True,
               'tpu_native_arch': False}
    if cfg.get('refine_net_enabled', False):
        written.update(refine_net_rnn_type='CLSTM', refine_net_use_rnn=True,
                       refine_net_rnn_num_cells=1, load_screen_content=True,
                       refine_net_use_skip_connections=True)
    for key, value in written.items():
        if cfg.get(key, value) != value:
            raise ValueError('the reference is written for %s = %r, not %r'
                             % (key, value, cfg[key]))
    nf = cfg['eye_net_rnn_num_features']
    specs = eye_net_specs(nf)
    if cfg.get('refine_net_enabled', False):
        specs += refine_net_specs(cfg['refine_net_num_features'], 4)
    return specs


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------

def _ident(t):
    return t


def conv(w, name, x, stride=1, padding=0, quant=_ident):
    return F.conv2d(quant(x), quant(w[name + '.weight']),
                    w.get(name + '.bias'), stride, padding)


def linear(w, name, x):
    return F.linear(x, w[name + '.weight'], w.get(name + '.bias'))


def inorm(x, w=None, name=None):
    """Instance norm: biased variance, eps 1e-5, optional affine."""
    if name is None:
        return F.instance_norm(x, eps=1e-5)
    return F.instance_norm(x, weight=w[name + '.weight'],
                           bias=w[name + '.bias'], eps=1e-5)


# ----------------------------------------------------------------------
# EyeNet
# ----------------------------------------------------------------------

def resnet18(w, x, quant=_ident):
    """(N, 3, H, W) in [-1, 1] -> (N, F)."""
    pre = 'eye_net.cnn_layers.'
    x = F.relu(inorm(conv(w, pre + 'conv1', x, 2, 3, quant)))
    x = F.max_pool2d(x, 3, 2, 1)
    for s in range(4):
        for b in range(2):
            blk = pre + 'layer%d.%d.' % (s + 1, b)
            stride = 2 if (b == 0 and s > 0) else 1
            if b == 0 and s > 0:
                identity = inorm(conv(w, blk + 'downsample.0', x, stride, 0,
                                      quant))
            else:
                identity = x
            out = F.relu(inorm(conv(w, blk + 'conv1', x, stride, 1, quant)))
            out = inorm(conv(w, blk + 'conv2', out, 1, 1, quant))
            x = F.relu(out + identity)
    return linear(w, pre + 'fc', x.mean(dim=(-2, -1)))


def eye_features(w, patches_u8, head_pose, quant=_ident):
    """(N, H, W, 3) uint8 eye patches and (N, 2) head pose -> (N, F)."""
    x = patches_u8.float() * (2.0 / 255.0) - 1.0
    f = resnet18(w, x.permute(0, 3, 1, 2).contiguous(), quant)
    f = torch.cat([f, head_pose.float()], dim=-1)
    return linear(w, 'eye_net.fc_common.2',
                  F.selu(linear(w, 'eye_net.fc_common.0', f)))


def gru_step(w, x, h):
    """torch's GRU cell: gates r, z, n."""
    pre = 'eye_net.rnn_cells.0.'
    gi = F.linear(x, w[pre + 'weight_ih'], w[pre + 'bias_ih'])
    gh = F.linear(h, w[pre + 'weight_hh'], w[pre + 'bias_hh'])
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def eye_heads(w, x):
    """Gaze (pitch, yaw) in +-pi/2 and pupil size >= 0."""
    g = linear(w, 'eye_net.fc_to_gaze.2',
               F.selu(linear(w, 'eye_net.fc_to_gaze.0', x)))
    p = linear(w, 'eye_net.fc_to_pupil.2',
               F.selu(linear(w, 'eye_net.fc_to_pupil.0', x)))
    return 0.5 * math.pi * torch.tanh(g), F.relu(p)[..., 0]


def eye_net(w, batch, quant=_ident):
    """Per eye: gazes (B, T, 2) and pupil sizes (B, T), the GRU's state
    starting from zeros."""
    B, T = batch['left_eye_patch'].shape[:2]
    out = {}
    for side in ('left', 'right'):
        p = batch[side + '_eye_patch']
        f = eye_features(w, p.reshape((B * T,) + p.shape[2:]),
                         batch[side + '_h'].reshape(B * T, 2), quant)
        f = f.reshape(B, T, -1)
        h = f.new_zeros(B, f.shape[-1])
        seq = []
        for t in range(T):
            h = gru_step(w, f[:, t], h)
            seq.append(h)
        out[side] = eye_heads(w, torch.stack(seq, dim=1))
    return out


# ----------------------------------------------------------------------
# Geometry and heatmaps
# ----------------------------------------------------------------------

def pitchyaw_to_vector(a):
    """(..., 2) pitch/yaw -> (..., 3) unit vector."""
    sp, sy = torch.sin(a[..., 0]), torch.sin(a[..., 1])
    cp, cy = torch.cos(a[..., 0]), torch.cos(a[..., 1])
    return torch.stack([cp * sy, sp, cp * cy], dim=-1)


def _rotate(m, v):
    return torch.einsum('...ij,...j->...i', m, v)


def pog_px(origin, gaze, rotation, inv_camera_T, px_per_mm):
    """A gaze ray meeting the screen plane: its PoG in px, clamped."""
    d = -pitchyaw_to_vector(gaze)                 # camera perspective
    d = _rotate(rotation.transpose(-1, -2), d)
    d = _rotate(inv_camera_T[..., :3, :3], d)
    o = _rotate(inv_camera_T[..., :3, :3], origin) + inv_camera_T[..., :3, 3]
    t = (-o[..., 2] / (d[..., 2] + 1e-7))[..., None]
    mm = (o + t * d)[..., :2]
    px = mm * px_per_mm
    return torch.stack([px[..., 0].clamp(0.0, SCREEN_PX[0]),
                        px[..., 1].clamp(0.0, SCREEN_PX[1])], dim=-1)


def render_heatmap(centres_px, sigma, size=(128, 72)):
    """(N, 2) screen-px centres -> (N, H, W) Gaussians (+1e-8)."""
    w, h = size
    cx = centres_px[:, 0] * (w / SCREEN_PX[0])
    cy = centres_px[:, 1] * (h / SCREEN_PX[1])
    xs = torch.arange(w, dtype=torch.float32, device=centres_px.device)
    ys = torch.arange(h, dtype=torch.float32, device=centres_px.device)
    d2 = ((ys[None, :, None] - cy[:, None, None]) ** 2 +
          (xs[None, None, :] - cx[:, None, None]) ** 2)
    return torch.exp(-0.5 / sigma ** 2 * d2) + 1e-8


def soft_argmax(maps, beta=SOFTARGMAX_BETA):
    """(N, H, W) heatmaps -> (N, 2) screen px: the beta-softmax's
    expectation over a [0, 1] x [0, 1] grid, scaled and clamped."""
    n, h, w = maps.shape
    p = torch.softmax(beta * maps.reshape(n, h * w), dim=-1).reshape(n, h, w)
    x = (p.sum(dim=1) * torch.linspace(0, 1, w, device=maps.device)).sum(-1)
    y = (p.sum(dim=2) * torch.linspace(0, 1, h, device=maps.device)).sum(-1)
    return torch.stack([(SCREEN_PX[0] * x).clamp(0.0, SCREEN_PX[0]),
                        (SCREEN_PX[1] * y).clamp(0.0, SCREEN_PX[1])], dim=-1)


# ----------------------------------------------------------------------
# RefineNet
# ----------------------------------------------------------------------

def _act(x, leaky):
    return F.leaky_relu(x, 0.01) if leaky else F.relu(x)


def preact(w, pre, x, leaky, quant):
    def branch(name_norm, name_conv, y, k):
        return conv(w, pre + name_conv, _act(inorm(y, w, pre + name_norm),
                                             leaky), 1, k // 2, quant)
    out = branch('layers.0', 'layers.2', x, 3)
    out = branch('layers.3', 'layers.5', out, 3)
    skip = (branch('skip_layer.0', 'skip_layer.2', x, 1)
            if pre + 'skip_layer.0.weight' in w else x)
    return out + skip


def clstm_step(w, x, h, c, quant):
    """Conv-LSTM cell, gate order i, f, o, g."""
    gates = conv(w, _level_prefix(5) + 'rnn_cells.0.gates',
                 torch.cat([x, h], dim=1), 1, 1, quant)
    i, f, o, g = gates.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def refine_net(w, heatmap, screen, B, T, nf, quant=_ident):
    """(B*T, H, W) initial heatmaps and (B*T, 3, h, w) screens in [0, 1]
    -> (B*T, H, W) refined heatmaps."""
    hm = F.interpolate(heatmap[:, None], size=screen.shape[-2:],
                       mode='bilinear', align_corners=False)
    x = torch.cat([screen, hm], dim=1)
    x = conv(w, 'refine_net.initial.0', x, 1, 1, quant)
    x = F.relu(inorm(x, w, 'refine_net.initial.1'))
    x = conv(w, 'refine_net.initial.3', x, 1, 1, quant)
    skips = []
    for k in range(5):
        for j in range(NUM_ENC_BLOCKS[k]):
            x = preact(w, _level_prefix(k) + 'encoder_blocks.%d.' % j, x,
                       False, quant)
        skips.append(x)
        if k < 4:
            x = F.adaptive_max_pool2d(x, LEVEL_SHAPES[k + 1])
    # The released model's bottleneck: the CLSTM's state is carried from
    # frame to frame and its input passes on unchanged, so no output
    # depends on the state; it is computed as the model computes it.
    seq = x.reshape((B, T) + x.shape[1:])
    h = c = seq.new_zeros((B, nf) + LEVEL_SHAPES[4])
    for t in range(T):
        h, c = clstm_step(w, seq[:, t], h, c, quant)
    for k in range(4, -1, -1):
        x = preact(w, _level_prefix(k) + 'decoder_blocks.0.',
                   torch.cat([x, skips[k]], dim=1), True, quant)
        if k > 0:
            x = F.interpolate(x, size=LEVEL_SHAPES[k - 1], mode='bilinear',
                              align_corners=False)
    x = F.leaky_relu(conv(w, 'refine_net.final.0', x, 1, 1, quant), 0.01)
    x = conv(w, 'refine_net.final.2', x, 1, 0, quant)
    return torch.sigmoid(x)[:, 0]


# ----------------------------------------------------------------------
# The whole model
# ----------------------------------------------------------------------

def forward(w, cfg, batch, quant=_ident):
    """EVE over a (B, T, ...) batch of tensors (the client's keys), each
    clip from zero states: a dict of ``PoG_px_initial`` (B, T, 2),
    ``left_pupil_size``, ``right_pupil_size`` (B, T), ``left_g_initial``,
    ``right_g_initial`` (B, T, 2) and, with RefineNet, ``PoG_px_final``
    (B, T, 2)."""
    B, T = batch['left_eye_patch'].shape[:2]
    eyes = eye_net(w, batch, quant)
    out, pogs = {}, []
    for side in ('left', 'right'):
        g, pupil = eyes[side]
        out[side + '_g_initial'] = g
        out[side + '_pupil_size'] = pupil
        pogs.append(pog_px(batch[side + '_o'], g, batch[side + '_R'],
                           batch['inv_camera_transformation'],
                           batch['pixels_per_millimeter']))
    pog = 0.5 * (pogs[0] + pogs[1])
    out['PoG_px_initial'] = pog
    if cfg.get('refine_net_enabled', False):
        w_hm, h_hm = cfg['gaze_heatmap_size']
        hm = render_heatmap(pog.reshape(B * T, 2),
                            cfg['gaze_heatmap_sigma_initial'], (w_hm, h_hm))
        scr = batch['screen_frame']
        scr = (scr.float() * (1.0 / 255.0)).reshape((B * T,) + scr.shape[2:])
        final = refine_net(w, hm, scr.permute(0, 3, 1, 2).contiguous(), B, T,
                           cfg['refine_net_num_features'], quant)
        out['PoG_px_final'] = soft_argmax(final).reshape(B, T, 2)
    return out


# ----------------------------------------------------------------------
# EyeNet's training loss
# ----------------------------------------------------------------------

def angular_error_degrees(a, b):
    va, vb = pitchyaw_to_vector(a), pitchyaw_to_vector(b)
    sim = (va * vb).sum(-1) / (va.norm(dim=-1) * vb.norm(dim=-1))
    return torch.acos(sim.clamp(-1.0 + 1e-7, 1.0 - 1e-7)) * (180.0 / math.pi)


def masked_mean(per_frame, validity):
    """Each clip's mean over its valid frames, then the mean over clips."""
    v = validity.float()
    n = v.sum(dim=1)
    acc = (per_frame * v).sum(dim=1)
    return torch.where(n > 1, acc / n.clamp(min=1.0), acc).mean()


def eye_net_loss(w, cfg, batch):
    """EyeNet's training loss: the angular error of each eye's gaze and
    the L1 error of its pupil size, each weighted by its coefficient."""
    eyes = eye_net(w, batch)
    total = 0.0
    for side in ('left', 'right'):
        g, pupil = eyes[side]
        total = total + cfg['loss_coeff_g_ang_initial'] * masked_mean(
            angular_error_degrees(g, batch[side + '_g_tobii']),
            batch[side + '_g_tobii_validity'])
        total = total + cfg['loss_coeff_pupil_size'] * masked_mean(
            (pupil - batch[side + '_p']).abs(), batch[side + '_p_validity'])
    return total
