"""RefineNetTPU: eve_tpu's opt-in refinement topology, NCHW.

The counterpart of ``eve_tpu/models/refine_net_tpu.py``, with RefineNet's
contract: the initial heatmap (resized to 72x128) concatenated with the
screen frame goes through an encoder pyramid, a conv-RNN bottleneck at 5x8
and a decoder with skips, to a (72, 128) heatmap in (0, 1) that the same
soft-argmax reads. The recurrent states are RefineNet's, so streaming and
serving do not depend on the topology.

The topology differs:

- a 4x4 stride-4 convolution (``stem``) takes the input straight to
  128@18x32;
- the pyramid runs 128@18x32 -> 256@9x16 -> nf@5x8 (``enc_blocks``,
  RefineNet's pre-activation blocks, adaptive max-pool down; 9 -> 5 is the
  uneven case) and back (``dec_blocks``, bilinear up, skips concatenated);
- the head is a 3x3 convolution to 64 channels and a leaky ReLU
  (``final_0``), a zero-initialised 1x1 convolution to 16 = 4x4 channels
  (``final_2``), depth-to-space to 72x128, and a float32 sigmoid.

``readout='gated'`` adds eve_tpu's residual readout head: the float32 mean
of the pre-head features over H and W, ``gate_fc1`` (32 units, ReLU) and
the zero-initialised ``gate_fc2`` (4 units); the gate is
``sigmoid(out[:2] + GATE_LOGIT_BIAS)`` and ``delta = out[2:]`` (screen px),
which ``models/eve.py`` applies as
``initial + gate * (heatmap - initial) + delta``.

The network computes in ``compute_dtype`` with RefineNet's casts (the
heatmap cast before its resize and the concatenation); the sigmoid and the
gate head run float32. The module names are eve_tpu's, which
``utils/convert.py`` maps. It is not weight-compatible with the reference
topology.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from eve_tpu_torch.models.cells import CONV_CELLS
from eve_tpu_torch.models.layers import (
    Conv2d, LeakyReLU, adaptive_max_pool, cat_channels, depth_to_space,
    resize_bilinear)
from eve_tpu_torch.models.refine_net import PreactBlock, RefineNet

PATCH_SIZE = 4
LEVEL_SHAPES = ((18, 32), (9, 16), (5, 8))
LEVEL_CHANNELS = (128, 256)  # the innermost level has num_features
# sigmoid(-4) ~ 0.018: a zero-initialised gate head starts at
# final ~ initial.
GATE_LOGIT_BIAS = -4.0


class RefineNetTPU(nn.Module):
    def __init__(self, load_screen_content=True, use_skip_connections=True,
                 use_rnn=True, rnn_type='CGRU', rnn_num_cells=1,
                 num_features=64, clstm_carry_only=True,
                 compute_dtype=torch.float32, readout='heatmap'):
        super().__init__()
        if readout not in ('heatmap', 'gated'):
            raise ValueError("Unknown readout %r (expected 'heatmap' or "
                             "'gated')" % (readout,))
        self.compute_dtype = compute_dtype
        self.load_screen_content = load_screen_content
        self.use_skip_connections = use_skip_connections
        self.use_rnn = use_rnn
        self.rnn_type = rnn_type
        self.num_features = num_features
        self.clstm_carry_only = clstm_carry_only
        self.readout = readout
        nf = num_features
        c0, c1 = LEVEL_CHANNELS
        self.stem = Conv2d(4 if load_screen_content else 1, c0, PATCH_SIZE,
                           PATCH_SIZE, 0)
        self.enc_blocks = nn.ModuleList([
            PreactBlock(c0, c0, 'relu'),      # (18, 32)
            PreactBlock(c0, c1, 'relu'),      # (9, 16)
            PreactBlock(c1, nf, 'relu')])     # (5, 8)
        sk = 2 if use_skip_connections else 1
        self.dec_blocks = nn.ModuleList([
            PreactBlock(sk * c0, c0, 'leaky'),
            PreactBlock(sk * c1, c0, 'leaky'),
            PreactBlock(sk * nf, c1, 'leaky')])
        self.rnn_cells = nn.ModuleList(
            CONV_CELLS[rnn_type](nf, nf)
            for _ in range(rnn_num_cells if use_rnn else 0))
        self.final_0 = Conv2d(c0, c0 // 2, 3, 1, 1)
        self.final_act = LeakyReLU(0.01)
        self.final_2 = Conv2d(c0 // 2, PATCH_SIZE * PATCH_SIZE, 1, 1, 0)
        nn.init.zeros_(self.final_2.weight)
        nn.init.zeros_(self.final_2.bias)
        if readout == 'gated':
            self.gate_fc1 = nn.Linear(c0 // 2, 32)
            self.gate_fc2 = nn.Linear(32, 4)
            nn.init.zeros_(self.gate_fc2.weight)
            nn.init.zeros_(self.gate_fc2.bias)

    # The input contract, the bottleneck and its states are RefineNet's.
    assemble_input = RefineNet.assemble_input
    bottleneck_step = RefineNet.bottleneck_step
    init_state = RefineNet.init_state

    def _cells(self):
        return self.rnn_cells

    def encode(self, x):
        """Patchify stem + pyramid: ``(bottleneck_input, skips
        outer->inner)``."""
        x = self.stem(x.to(self.compute_dtype))
        if tuple(x.shape[-2:]) != LEVEL_SHAPES[0]:
            raise ValueError(
                'TPU-native RefineNet pyramid is built for 72x128 inputs '
                '(screen_size/gaze_heatmap_size = (128, 72)); got stem '
                'output %s' % (tuple(x.shape),))
        skips = []
        for k, block in enumerate(self.enc_blocks):
            x = block(x)
            skips.append(x)
            if k < 2:
                x = adaptive_max_pool(x, LEVEL_SHAPES[k + 1])
        return x, skips

    def _decode_features(self, x, skips):
        """The decoder up to the head's shared features, 64@18x32."""
        for k in range(2, -1, -1):
            if self.use_skip_connections:
                x = cat_channels([x, skips[k]])
            x = self.dec_blocks[k](x)
            if k > 0:
                x = resize_bilinear(x, LEVEL_SHAPES[k - 1])
        return self.final_act(self.final_0(x))

    def _heatmap(self, feats):
        x = depth_to_space(self.final_2(feats), PATCH_SIZE)
        return torch.sigmoid(x.float())[:, 0]

    def decode(self, x, skips):
        """Decoder + sub-pixel head: (N, 72, 128) heatmap in (0, 1)."""
        return self._heatmap(self._decode_features(x, skips))

    def decode_readout(self, x, skips):
        """Decoder, head and the gated readout: ``(heatmap (N, 72, 128),
        gate (N, 2) in (0, 1), delta_px (N, 2))``, gate and delta in
        PoG_px's (x, y) order."""
        feats = self._decode_features(x, skips)
        # jnp.mean of bfloat16 accumulates in float32 and rounds to
        # bfloat16; the gate head then runs float32.
        pooled = feats.mean(dim=(-2, -1), dtype=torch.float32).to(
            feats.dtype).float()
        out = self.gate_fc2(F.relu(self.gate_fc1(pooled)))
        gate = torch.sigmoid(out[:, :2] + GATE_LOGIT_BIAS)
        return self._heatmap(feats), gate, out[:, 2:]
