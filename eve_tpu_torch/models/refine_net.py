"""RefineNet: conditional encoder-decoder heatmap refinement, NCHW.

The counterpart of ``eve_tpu/models/refine_net.py``, laid out as the
reference nests it so that its state_dict names carry over: ``initial``,
``final`` and ``network``, where level k of the pyramid lives under
``network.`` + ``between_module.`` * k (``encoder_blocks``,
``decoder_blocks``) and the conv-RNN bottleneck under
``network.`` + ``between_module.`` * 5 (``rnn_cells``).

The pyramid runs 16@72x128 -> 32@36x64 -> 64@18x32 -> 128@9x16 -> 256@5x8
and into the nf-channel bottleneck at 5x8, with pre-activation residual
blocks (1, 2, 2, 2, 2 per encoder level), adaptive max-pool down, bilinear
up and optional skip concatenation; the head is a zero-initialised 1x1 conv
and a sigmoid computed in float32.

As in eve_tpu, ``encode`` and ``decode`` run batched over every frame and
only ``bottleneck_step`` runs per timestep. The network computes in
``compute_dtype`` (eve_tpu's casts): the initial heatmap is cast before its
resize, the screen before the concatenation, the encoder's input once
more, the conv-RNN states are created in it, and the head's output returns
to float32 before the sigmoid. Reference quirk: with a
tuple-state cell (CLSTM) and ``clstm_carry_only``, the cell's output is
discarded and only its state is carried; the bottleneck passes its input on.
"""

import torch
import torch.nn as nn

from eve_tpu_torch.models.cells import CONV_CELLS, zero_state
from eve_tpu_torch.models.layers import (
    Conv2d, InstanceNorm, LeakyReLU, adaptive_max_pool, cat_channels,
    resize_bilinear)

LEVEL_CHANNELS = (16, 32, 64, 128, 256)
LEVEL_SHAPES = ((72, 128), (36, 64), (18, 32), (9, 16), (5, 8))
NUM_ENC_BLOCKS = (1, 2, 2, 2, 2)


class PreactBlock(nn.Module):
    """IN-act-conv3 / IN-act-conv3, plus a skip (IN-act-conv1 if widths differ).

    Each norm applies the block's activation ``act`` ('relu' or 'leaky')
    itself; the activation's slot of each ``nn.Sequential`` holds an
    ``nn.Identity`` so that the state_dict names stay the reference's
    (``layers.0/2/3/5``, ``skip_layer.0/2``).
    """

    def __init__(self, in_features, out_features, act='relu'):
        super().__init__()
        self.layers = nn.Sequential(
            InstanceNorm(in_features, affine=True, act=act), nn.Identity(),
            Conv2d(in_features, out_features, 3, 1, 1),
            InstanceNorm(out_features, affine=True, act=act), nn.Identity(),
            Conv2d(out_features, out_features, 3, 1, 1))
        self.skip_layer = None
        if in_features != out_features:
            self.skip_layer = nn.Sequential(
                InstanceNorm(in_features, affine=True, act=act),
                nn.Identity(), Conv2d(in_features, out_features, 1, 1, 0))

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return self.layers(x) + skip


class _Bottleneck(nn.Module):
    def __init__(self, cell_cls, num_features, num_cells):
        super().__init__()
        self.rnn_cells = nn.ModuleList(
            cell_cls(num_features, num_features) for _ in range(num_cells))


class _Level(nn.Module):
    """One pyramid level: its encoder and decoder blocks and the level below."""

    def __init__(self, k, num_features, use_skip_connections, inner):
        super().__init__()
        out_c = LEVEL_CHANNELS[k + 1] if k < 4 else num_features
        self.encoder_blocks = nn.ModuleList(
            [PreactBlock(LEVEL_CHANNELS[k], out_c, 'relu')] +
            [PreactBlock(out_c, out_c, 'relu')
             for _ in range(1, NUM_ENC_BLOCKS[k])])
        in_c = 2 * out_c if use_skip_connections else out_c
        dec_out = LEVEL_CHANNELS[k] if k < 4 else LEVEL_CHANNELS[4]
        self.decoder_blocks = nn.ModuleList(
            [PreactBlock(in_c, dec_out, 'leaky')])
        self.between_module = inner


class RefineNet(nn.Module):
    def __init__(self, load_screen_content=True, use_skip_connections=True,
                 use_rnn=True, rnn_type='CGRU', rnn_num_cells=1,
                 num_features=64, clstm_carry_only=True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.load_screen_content = load_screen_content
        self.use_skip_connections = use_skip_connections
        self.use_rnn = use_rnn
        self.rnn_type = rnn_type
        self.num_features = num_features
        self.clstm_carry_only = clstm_carry_only
        in_c = 4 if load_screen_content else 1
        self.initial = nn.Sequential(
            Conv2d(in_c, 16, 3, 1, 1),
            InstanceNorm(16, affine=True, act='relu'), nn.Identity(),
            Conv2d(16, 16, 3, 1, 1))
        cell_cls = CONV_CELLS[rnn_type]
        inner = _Bottleneck(cell_cls, num_features,
                            rnn_num_cells if use_rnn else 0)
        for k in range(4, -1, -1):
            inner = _Level(k, num_features, use_skip_connections, inner)
        self.network = inner
        self.final = nn.Sequential(
            Conv2d(16, 16, 3, 1, 1), LeakyReLU(0.01),
            Conv2d(16, 1, 1, 1, 0))
        nn.init.zeros_(self.final[2].weight)
        nn.init.zeros_(self.final[2].bias)

    def _levels(self):
        level = self.network
        while isinstance(level, _Level):
            yield level
            level = level.between_module

    def _cells(self):
        level = self.network
        while isinstance(level, _Level):
            level = level.between_module
        return level.rnn_cells

    def assemble_input(self, heatmap_initial, screen_frame=None,
                       screen_size=(128, 72)):
        """(N, H, W) heatmap [+ (N, 3, h, w) screen] -> (N, C, h, w), in
        the compute type (both cast before the resize and concatenation)."""
        hm = resize_bilinear(
            heatmap_initial.to(self.compute_dtype).unsqueeze(1),
            (screen_size[1], screen_size[0]))
        if self.load_screen_content:
            return cat_channels([screen_frame.to(self.compute_dtype), hm])
        return hm

    def encode(self, x):
        """Stem + encoder pyramid: ``(bottleneck_input, skips outer->inner)``."""
        x = self.initial(x.to(self.compute_dtype))
        skips = []
        for k, level in enumerate(self._levels()):
            for block in level.encoder_blocks:
                x = block(x)
            skips.append(x)
            if k < 4:
                x = adaptive_max_pool(x, LEVEL_SHAPES[k + 1])
        return x, skips

    def bottleneck_step(self, x, states):
        """One timestep of the conv-RNN bottleneck."""
        if not self.use_rnn:
            return x, states
        new_states = []
        for cell, s in zip(self._cells(), states):
            out, ns = cell(x, s)
            new_states.append(ns)
            if not (cell.tuple_state and self.clstm_carry_only):
                x = out
        return x, tuple(new_states)

    def decode(self, x, skips):
        """Decoder pyramid + head: (N, 72, 128) heatmap in (0, 1)."""
        levels = list(self._levels())
        for k in range(4, -1, -1):
            if self.use_skip_connections:
                x = cat_channels([x, skips[k]])
            x = levels[k].decoder_blocks[0](x)
            if k > 0:
                x = resize_bilinear(x, LEVEL_SHAPES[k - 1])
        x = self.final(x)
        return torch.sigmoid(x.float())[:, 0]

    def init_state(self, batch_size, device=None):
        """Zero conv-RNN states at the 5x8 bottleneck in the compute type
        (empty without RNN)."""
        if not self.use_rnn:
            return ()
        return tuple(
            zero_state(CONV_CELLS[self.rnn_type], self.num_features,
                       batch_size, hw=LEVEL_SHAPES[4], device=device,
                       dtype=self.compute_dtype)
            for _ in self._cells())
