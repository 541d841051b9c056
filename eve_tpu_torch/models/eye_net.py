"""EyeNet: per-eye gaze direction and pupil size, NCHW.

The counterpart of ``eve_tpu/models/eye_net.py``, with the reference's
state_dict names: ResNet-18/InstanceNorm backbone (``cnn_layers``) ->
optional 2D head-pose concat -> ``fc_common`` (Linear, SELU, Linear) ->
dense RNN cells (``rnn_cells``, default one GRU-128) or ``static_fc`` ->
gaze head (``fc_to_gaze``: pi/2 * tanh, zero-initialised final layer, no
bias) and pupil head (``fc_to_pupil``: ReLU).

The work is split as in eve_tpu: ``features`` (backbone + ``fc_common``) is
recurrence-free and runs batched over every frame of both eyes; only
``recurrent`` runs per timestep; ``heads`` runs batched afterwards.

``compute_dtype`` and ``stem`` are the backbone's (see ``resnet``);
``fc_common``, the cells and the heads run float32, as in eve_tpu.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from eve_tpu_torch.models.cells import DENSE_CELLS, zero_state
from eve_tpu_torch.models.resnet import ResNet18IN

HALF_PI = 0.5 * math.pi


class EyeNet(nn.Module):
    def __init__(self, num_features=128, use_rnn=True, rnn_type='GRU',
                 rnn_num_cells=1, use_head_pose_input=True,
                 compute_dtype=torch.float32, stem='reference'):
        super().__init__()
        nf = num_features
        self.num_features = nf
        self.use_rnn = use_rnn
        self.rnn_type = rnn_type
        self.use_head_pose_input = use_head_pose_input
        self.cnn_layers = ResNet18IN(num_classes=nf,
                                     compute_dtype=compute_dtype, stem=stem)
        self.fc_common = nn.Sequential(
            nn.Linear(nf + (2 if use_head_pose_input else 0), nf),
            nn.SELU(),
            nn.Linear(nf, nf))
        if use_rnn:
            cell_cls = DENSE_CELLS[rnn_type]
            self.rnn_cells = nn.ModuleList(
                cell_cls(nf, nf) for _ in range(rnn_num_cells))
        else:
            self.static_fc = nn.Sequential(nn.Linear(nf, nf), nn.SELU())
        self.fc_to_gaze = nn.Sequential(
            nn.Linear(nf, nf), nn.SELU(), nn.Linear(nf, 2, bias=False))
        nn.init.zeros_(self.fc_to_gaze[2].weight)
        self.fc_to_pupil = nn.Sequential(
            nn.Linear(nf, nf), nn.SELU(), nn.Linear(nf, 1))

    def features(self, eye_patch, head_pose=None):
        """(N, 3, H, W) patches -> (N, F) features; recurrence-free."""
        f = self.cnn_layers(eye_patch)
        if self.use_head_pose_input:
            f = torch.cat([f, head_pose.to(f.dtype)], dim=-1)
        return self.fc_common(f)

    def recurrent(self, features, states):
        """One timestep of the cell stack: ``(output, new_states)``."""
        f = features
        new_states = []
        for cell, s in zip(self.rnn_cells, states):
            f, ns = cell(f, s)
            new_states.append(ns)
        return f, tuple(new_states)

    def static_path(self, features):
        """Non-recurrent alternative to the cell stack (Linear + SELU)."""
        return self.static_fc(features)

    def heads(self, features):
        """Gaze (pitch, yaw) in +-pi/2 and pupil size >= 0."""
        gaze = HALF_PI * torch.tanh(self.fc_to_gaze(features))
        pupil = F.relu(self.fc_to_pupil(features))[..., 0]
        return gaze, pupil

    def init_state(self, batch_size, device=None):
        """Zero states of the cell stack (empty without an RNN)."""
        if not self.use_rnn:
            return ()
        return tuple(
            zero_state(DENSE_CELLS[self.rnn_type], self.num_features,
                       batch_size, device=device)
            for _ in self.rnn_cells)
