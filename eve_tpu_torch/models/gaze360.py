"""Gaze360: a ResNet-18/BN per frame and a 2-layer bidirectional LSTM over
7-frame windows, on EVE's face video.

Kellnhofer et al., *Gaze360: Physically Unconstrained Gaze Estimation in
the Wild*, ICCV 2019 (github.com/erkil1452/gaze360, ``code/model.py``
``GazeLSTM`` and ``code/resnet.py``), with its state_dict names:
``base_model.*`` (``resnet.ResNet18BN``: torchvision's ResNet-18 with
``fc1`` 512 -> 1000, ReLU, ``fc2`` 1000 -> 256), ``lstm.*``
(``nn.LSTM(256, 256, num_layers=2, bidirectional=True, batch_first=True)``)
and ``last_layer.*`` (512 -> 3).

The output at frame t reads the window t-3 .. t+3: the LSTM's top layer
``[h_fwd; h_bwd]`` at the middle step, each direction from a zero state.
From the head's ``o``: yaw ``pi * tanh(o0)``, pitch ``pi/2 * tanh(o1)`` and
one spread ``pi * sigmoid(o2)`` for both angles (``gaze_spread``). The
(pitch, yaw) pair is read as EVE's face gaze in the face's normalised
frame and projected through ``face_o`` and ``face_R``
(``ops.geometry.to_screen_coordinates``).

The published forward runs the backbone on every window's 7 frames. Here
a (B, T) clip batch runs it once a frame, on all B*T frames in one batch,
then gathers the (B*T, 7, 256) windows of features, the frame indices
clamped to [0, T-1] at the clip's edges, and runs one batched LSTM:

  1. the uint8 face frames (``frame``, (B, T, H, W, 3), as the data reader
     gives ``camera_frame_type='face'`` clips) normalised with ImageNet's
     mean and std in float32, then cast to the compute type; the NHWC
     frames enter the backbone as a channels-last NCHW view;
  2. the backbone over the B*T frames, each eval-mode BatchNorm folded into
     the convolution before it (``resnet.ResNet18BN.fold_norms``, when the
     model is built);
  3. ``fc1``, ReLU and ``fc2`` in float32;
  4. the window gather and the LSTM in float32, the middle step's output;
  5. the head, then the screen projection.

Tracing (``eve_tpu_torch.tracing``): stages 1-3 are the span
``gaze360.backbone`` (a CUDA event pair; its ``key`` is the count of
frames the backbone ran, B*T, where recomputed windows would read 7 times
that) and stage 4 with the head ``gaze360.temporal`` (an event pair).

Only inference runs: serving, export and training refuse the model
(``models.zoo``): serving would need a 3-frame look-ahead, training the
pinball loss and BatchNorm's batch statistics.
"""

import dataclasses
import logging
import math
import os
from typing import Tuple

import torch
import torch.nn as nn

from eve_tpu_torch import tracing
from eve_tpu_torch.models.layers import BatchNorm
from eve_tpu_torch.models.resnet import ResNet18BN
from eve_tpu_torch.ops import geometry as geo

logger = logging.getLogger(__name__)

WINDOW = 7
FEATURES = 256
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# The key of the face frames in a clip batch: the data reader's for every
# camera_frame_type other than 'eyes'.
FRAME_KEY = 'frame'
# The published checkpoint's file name (a torch.save of {'state_dict':
# ...}, keys prefixed 'module.' by DataParallel).
PRETRAINED_FILE = 'gaze360_model.pth.tar'
PASS_THROUGH = ('timestamps', 'face_o', 'face_R', 'head_R',
                'millimeters_per_pixel', 'pixels_per_millimeter',
                'camera_transformation', 'inv_camera_transformation')


@dataclasses.dataclass(frozen=True)
class GazeSpec:
    """Static specification of a Gaze360 model."""
    compute_dtype: str = 'float32'
    actual_screen_size: Tuple[int, int] = (1920, 1080)

    @property
    def dtype(self):
        """The backbone's torch compute type ('bfloat16', else float32)."""
        return (torch.bfloat16 if self.compute_dtype == 'bfloat16'
                else torch.float32)

    @classmethod
    def from_config(cls, config):
        if config.camera_frame_type != 'face':
            raise ValueError(
                "gaze_net 'gaze360' reads face video: set "
                "camera_frame_type 'face' (got %r)"
                % (config.camera_frame_type,))
        return cls(compute_dtype=config.tpu_compute_dtype,
                   actual_screen_size=tuple(config.actual_screen_size))


def window_indices(T, device=None):
    """(T, WINDOW) frame indices of each frame's window, t-3 .. t+3,
    clamped to [0, T-1]."""
    half = WINDOW // 2
    t = torch.arange(T, device=device)[:, None]
    k = torch.arange(-half, half + 1, device=device)[None, :]
    return (t + k).clamp(0, T - 1)


class Gaze360(nn.Module):
    """``base_model``, ``lstm`` and ``last_layer`` (see the module
    docstring)."""

    def __init__(self, spec: GazeSpec):
        super().__init__()
        self.spec = spec
        self.base_model = ResNet18BN(FEATURES, compute_dtype=spec.dtype)
        self.lstm = nn.LSTM(FEATURES, FEATURES, num_layers=2,
                            bidirectional=True, batch_first=True)
        self.last_layer = nn.Linear(2 * FEATURES, 3)
        mean = torch.tensor(IMAGENET_MEAN)
        std = torch.tensor(IMAGENET_STD)
        self.register_buffer('pixel_mean', mean, persistent=False)
        self.register_buffer('pixel_std', std, persistent=False)

    def frame_features(self, frames):
        """(N, H, W, 3) uint8 frames -> (N, 256) float32 features."""
        x = frames.float() * (1.0 / 255.0)
        x = (x - self.pixel_mean) / self.pixel_std
        return self.base_model(x.permute(0, 3, 1, 2).to(self.spec.dtype))

    def temporal(self, features):
        """(B, T, 256) features -> (B, T, 3) head outputs: each frame's
        window through the LSTM, the middle step."""
        B, T, F = features.shape
        windows = features[:, window_indices(T, features.device)]
        out, _ = self.lstm(windows.reshape(B * T, WINDOW, F))
        return self.last_layer(out[:, WINDOW // 2]).reshape(B, T, 3)

    def forward(self, batch, output_predictions=True, create_images=False):
        """A (B, T, ...) clip batch of tensors -> ``g_initial`` (B, T, 2)
        (pitch, yaw), ``gaze_spread`` (B, T), ``PoG_px_initial`` and
        ``PoG_cm_initial`` (B, T, 2) where the batch holds the camera
        geometry, and the pass-throughs of ``PASS_THROUGH`` in the batch.
        ``output_predictions`` and ``create_images`` are the EVE
        forward's arguments; Gaze360 has no image outputs."""
        frames = batch[FRAME_KEY]
        B, T = frames.shape[:2]
        with tracing.span('gaze360.backbone', device=True) as span:
            if span is not None:
                span.key = B * T
            features = self.frame_features(
                frames.reshape((B * T,) + frames.shape[2:]))
        with tracing.span('gaze360.temporal', device=True):
            o = self.temporal(features.reshape(B, T, FEATURES))
            yaw = math.pi * torch.tanh(o[..., 0])
            pitch = 0.5 * math.pi * torch.tanh(o[..., 1])
            g = torch.stack([pitch, yaw], dim=-1)
            spread = math.pi * torch.sigmoid(o[..., 2])
        out = {'g_initial': g, 'gaze_spread': spread}
        if 'inv_camera_transformation' in batch:
            pog_mm, pog_px = geo.to_screen_coordinates(
                batch['face_o'], g, batch['face_R'], batch,
                actual_screen_size=self.spec.actual_screen_size)
            out['PoG_px_initial'] = pog_px
            out['PoG_cm_initial'] = 0.1 * pog_mm
        for k in PASS_THROUGH:
            if k in batch:
                out[k] = batch[k]
        return out


def init_weights(model, generator):
    """torchvision's and torch's initialisers, drawn on ``generator`` (a
    CPU ``torch.Generator``) and copied to the model's device:
    convolutions kaiming-normal (fan out, ReLU gain), norms 1 and 0 with
    zero mean and unit variance, linear layers uniform in
    +-1/sqrt(fan in), the LSTM in +-1/sqrt(hidden)."""
    def fill(p, sample):
        with torch.no_grad():
            p.copy_(sample(torch.empty(p.shape)))

    def uniform(bound):
        return lambda t: t.uniform_(-bound, bound, generator=generator)

    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            o, _, kh, kw = module.weight.shape
            std = math.sqrt(2.0 / (o * kh * kw))
            fill(module.weight,
                 lambda t: t.normal_(0.0, std, generator=generator))
        elif isinstance(module, BatchNorm):
            for p, value in ((module.weight, 1.0), (module.bias, 0.0),
                             (module.running_mean, 0.0),
                             (module.running_var, 1.0)):
                fill(p, lambda t, v=value: t.fill_(v))
        elif isinstance(module, nn.Linear):
            for p in module.parameters():
                fill(p, uniform(1.0 / math.sqrt(module.in_features)))
        elif isinstance(module, nn.LSTM):
            for p in module.parameters():
                fill(p, uniform(1.0 / math.sqrt(module.hidden_size)))
    return model


def build_model(spec, state_dict, device='cuda'):
    """A ``Gaze360`` in eval mode on ``device`` holding ``state_dict``
    (the published names, strict), its norms folded."""
    with torch.device('meta'):
        model = Gaze360(spec)
    model = model.to_empty(device=device)
    model.pixel_mean.copy_(torch.tensor(IMAGENET_MEAN))
    model.pixel_std.copy_(torch.tensor(IMAGENET_STD))
    model.load_state_dict(state_dict, strict=True)
    return _ready(model)


def init_model(spec, generator, device='cuda'):
    """A freshly initialised ``Gaze360`` (see ``init_weights``) in eval
    mode, its norms folded."""
    model = Gaze360(spec).to(device)
    return _ready(init_weights(model, generator))


def _ready(model):
    model.base_model.fold_norms()
    # cuDNN's LSTM takes its weights as one buffer.
    model.lstm.flatten_parameters()
    return model.eval()


def published_state_dict(loaded):
    """The model's state dict from a loaded checkpoint: the published
    ``{'state_dict': ...}`` (or a bare state dict), with DataParallel's
    ``module.`` prefix stripped."""
    sd = loaded.get('state_dict', loaded)
    return {k[len('module.'):] if k.startswith('module.') else k: v
            for k, v in sd.items()}


def weights_file(config, pretrained_dir=None):
    """Where the weights come from: ``<resume_from>/gaze360_model.pth.tar``
    with ``resume_from`` (which must exist), else the first
    ``gaze360_model.pth.tar`` in ``pretrained_dir`` or
    ``$EVE_PRETRAINED_DIR``, else None."""
    if config.resume_from:
        path = os.path.join(config.resume_from, PRETRAINED_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return path
    for d in (pretrained_dir, os.environ.get('EVE_PRETRAINED_DIR')):
        if d and os.path.isfile(os.path.join(d, PRETRAINED_FILE)):
            return os.path.join(d, PRETRAINED_FILE)
    return None


def model_setup(config, require_weights=False, device='cuda',
                pretrained_dir=None):
    """``infer.model_setup`` for ``gaze_net`` 'gaze360': the model from
    ``weights_file``; without one, seed-0 weights, or a ``RuntimeError``
    under ``require_weights``."""
    spec = GazeSpec.from_config(config)
    path = weights_file(config, pretrained_dir)
    if path is None:
        if require_weights:
            raise RuntimeError(
                'No Gaze360 weights: pass --resume-from <dir> holding %s or '
                'place it under $EVE_PRETRAINED_DIR (refusing to run '
                'randomly initialized parameters).' % PRETRAINED_FILE)
        logger.warning('No %s found: Gaze360 runs seed-0 weights',
                       PRETRAINED_FILE)
        return init_model(spec, torch.Generator().manual_seed(0), device)
    logger.info('Loading Gaze360 weights from %s', path)
    state = published_state_dict(torch.load(path, map_location='cpu',
                                            weights_only=True))
    return build_model(spec, state, device)
