"""EVE composite model: EyeNet + geometry + heatmaps + RefineNet + losses.

The counterpart of ``eve_tpu/models/eve.py`` for inference, with the same
staging of a (B, T, ...) clip batch:

  1. ResNet features for all (B, T, 2 eyes) frames in one batch.
  2. One loop over T for the dense cell stack only, on a (2B, F) stack of
     both eyes (the eyes share the cell weights).
  3. Gaze/pupil heads, screen projection and the initial heatmap render
     (the render kernel on the card), batched over (B, T).
  4. The RefineNet encoder for all (B, T) frames in one batch.
  5. One loop over T for the conv-RNN bottleneck only.
  6. The RefineNet decoder, soft-argmax (the soft-argmax kernel on the
     card), losses and metrics, batched.

The public batch is eve_tpu's: the same keys, NHWC image tensors, uint8 or
float frames; the NHWC -> NCHW permute happens once, here. Output, loss and
metric names are eve_tpu's.

``forward(training=True, generator=...)`` is eve_tpu's training forward:
the initial gazes get a kappa offset (``std * N(0, 1)`` per clip and eye,
drawn on a CPU ``torch.Generator`` so that the card and the CPU draw the
same kappas, or injected as ``left_kappa_fake``/``right_kappa_fake``), and
the initial losses read the unaugmented ``*_unaugmented`` branch. With
``eye_net_frozen`` EyeNet's parameters do not require gradients and its
stages run under ``torch.no_grad()``. The bfloat16 compute type, the opt-in
TPU-native topology, the sequence mesh and rematerialization are later
slices.
"""

import contextlib
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from eve_tpu_torch import losses as losses_lib
from eve_tpu_torch.models.cells import CONV_CELLS, DENSE_CELLS, zero_state
from eve_tpu_torch.models.eye_net import EyeNet
from eve_tpu_torch.models.layers import InstanceNorm
from eve_tpu_torch.models.refine_net import LEVEL_SHAPES, RefineNet
from eve_tpu_torch.ops import geometry as geo
from eve_tpu_torch.ops import heatmap as hm_ops


@dataclasses.dataclass(frozen=True)
class EveSpec:
    """Static model specification: the fields of eve_tpu's ``EveSpec`` that
    the reference topology reads."""
    # EyeNet
    eye_net_use_rnn: bool = True
    eye_net_rnn_type: str = 'GRU'
    eye_net_rnn_num_cells: int = 1
    eye_net_num_features: int = 128
    eye_net_use_head_pose_input: bool = True
    eye_net_frozen: bool = False
    # RefineNet
    refine_net_enabled: bool = False
    refine_net_do_offset_augmentation: bool = True
    refine_net_offset_augmentation_sigma: float = 3.0
    refine_net_offset_augmentation_zero_prob: float = 0.0
    refine_net_use_skip_connections: bool = True
    refine_net_use_rnn: bool = True
    refine_net_rnn_type: str = 'CGRU'
    refine_net_rnn_num_cells: int = 1
    refine_net_num_features: int = 64
    clstm_carry_only: bool = True
    load_screen_content: bool = False
    # Heatmaps
    gaze_heatmap_size: Tuple[int, int] = (128, 72)
    gaze_heatmap_sigma_initial: float = 10.0
    gaze_heatmap_sigma_history: float = 3.0
    gaze_heatmap_sigma_final: float = 5.0
    actual_screen_size: Tuple[int, int] = (1920, 1080)
    screen_size: Tuple[int, int] = (128, 72)
    # Loss coefficients
    loss_coeff_g_ang_initial: float = 1.0
    loss_coeff_PoG_cm_initial: float = 0.0
    loss_coeff_pupil_size: float = 1.0
    loss_coeff_PoG_cm_final: float = 0.001
    loss_coeff_heatmap_ce_initial: float = 0.0
    loss_coeff_heatmap_ce_final: float = 1.0
    loss_coeff_heatmap_mse_final: float = 0.0
    # Compute type of the networks
    compute_dtype: str = 'float32'

    @classmethod
    def from_config(cls, config):
        """Build from an ``eve_tpu_torch.config.Config``."""
        if config.tpu_native_arch:
            raise NotImplementedError(
                'tpu_native_arch (the opt-in topology) is a later slice of '
                'the port; see ROADMAP.md')
        return cls(
            eye_net_use_rnn=config.eye_net_use_rnn,
            eye_net_rnn_type=config.eye_net_rnn_type,
            eye_net_rnn_num_cells=config.eye_net_rnn_num_cells,
            eye_net_num_features=(config.eye_net_rnn_num_features
                                  if config.eye_net_use_rnn
                                  else config.eye_net_static_num_features),
            eye_net_use_head_pose_input=config.eye_net_use_head_pose_input,
            eye_net_frozen=config.eye_net_frozen,
            refine_net_enabled=config.refine_net_enabled,
            refine_net_do_offset_augmentation=(
                config.refine_net_do_offset_augmentation),
            refine_net_offset_augmentation_sigma=(
                config.refine_net_offset_augmentation_sigma),
            refine_net_offset_augmentation_zero_prob=(
                config.refine_net_offset_augmentation_zero_prob),
            refine_net_use_skip_connections=(
                config.refine_net_use_skip_connections),
            refine_net_use_rnn=config.refine_net_use_rnn,
            refine_net_rnn_type=config.refine_net_rnn_type,
            refine_net_rnn_num_cells=config.refine_net_rnn_num_cells,
            refine_net_num_features=config.refine_net_num_features,
            clstm_carry_only=config.reference_compat_clstm_carry_only,
            load_screen_content=config.load_screen_content,
            gaze_heatmap_size=tuple(config.gaze_heatmap_size),
            gaze_heatmap_sigma_initial=config.gaze_heatmap_sigma_initial,
            gaze_heatmap_sigma_history=config.gaze_heatmap_sigma_history,
            gaze_heatmap_sigma_final=config.gaze_heatmap_sigma_final,
            actual_screen_size=tuple(config.actual_screen_size),
            screen_size=tuple(config.screen_size),
            loss_coeff_g_ang_initial=config.loss_coeff_g_ang_initial,
            loss_coeff_PoG_cm_initial=config.loss_coeff_PoG_cm_initial,
            loss_coeff_pupil_size=config.loss_coeff_pupil_size,
            loss_coeff_PoG_cm_final=config.loss_coeff_PoG_cm_final,
            loss_coeff_heatmap_ce_initial=config.loss_coeff_heatmap_ce_initial,
            loss_coeff_heatmap_ce_final=config.loss_coeff_heatmap_ce_final,
            loss_coeff_heatmap_mse_final=config.loss_coeff_heatmap_mse_final,
            compute_dtype=config.tpu_compute_dtype,
        )


def _to_compute(x):
    """Camera frames to float32; uint8 gets ``*2/255-1`` on the device."""
    if x.dtype == torch.uint8:
        return x.float() * (2.0 / 255.0) - 1.0
    return x.float()


def _screen_to_float(x):
    """Screen frames: uint8 -> [0, 1] float32 on the device."""
    if x is not None and x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x


def _nhwc_to_nchw(x):
    """(N, H, W, C) -> contiguous (N, C, H, W)."""
    return x.permute(0, 3, 1, 2).contiguous()


def tree_map(fn, *trees):
    """Map over matching nested dicts and tuples (recurrent states)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def batch_to_tensors(batch, device):
    """numpy or tensor batch -> tensors on ``device`` (float64 -> float32)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            v = torch.from_numpy(np.require(v, requirements=('C', 'W')))
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.float64:
                v = v.float()
            out[k] = v.to(device, non_blocking=True)
    return out


class EVE(nn.Module):
    """EyeNet (``eye_net``) and, when enabled, RefineNet (``refine_net``)."""

    def __init__(self, spec: EveSpec):
        super().__init__()
        if spec.compute_dtype != 'float32':
            raise NotImplementedError(
                'compute_dtype=%r: the port runs float32; the bfloat16 '
                'compute path is a later slice (see ROADMAP.md)'
                % spec.compute_dtype)
        self.spec = spec
        self.eye_net = EyeNet(
            num_features=spec.eye_net_num_features,
            use_rnn=spec.eye_net_use_rnn,
            rnn_type=spec.eye_net_rnn_type,
            rnn_num_cells=spec.eye_net_rnn_num_cells,
            use_head_pose_input=spec.eye_net_use_head_pose_input)
        self.refine_net = None
        if spec.refine_net_enabled:
            self.refine_net = RefineNet(
                load_screen_content=spec.load_screen_content,
                use_skip_connections=spec.refine_net_use_skip_connections,
                use_rnn=spec.refine_net_use_rnn,
                rnn_type=spec.refine_net_rnn_type,
                rnn_num_cells=spec.refine_net_rnn_num_cells,
                num_features=spec.refine_net_num_features,
                clstm_carry_only=spec.clstm_carry_only)
        if spec.eye_net_frozen:
            # As the reference freezes it: no gradient, no optimizer state.
            self.eye_net.requires_grad_(False)

    def forward(self, batch, training=False, generator=None,
                output_predictions=False, initial_states=None,
                return_states=False):
        """Full EVE forward over a (B, T, ...) clip batch of tensors.

        Returns the output dict of losses, metrics and (optionally)
        predictions, with eve_tpu's key names; ``return_states`` adds the
        final recurrent states (see ``init_stream_state``) under 'states'.
        ``training`` turns on the kappa offset augmentation, whose kappas
        are drawn on ``generator`` (a CPU ``torch.Generator``) unless the
        batch carries ``left_kappa_fake`` and ``right_kappa_fake``.
        """
        spec = self.spec
        eye_net, refine_net = self.eye_net, self.refine_net
        full = dict(batch)
        full.update(calculate_additional_labels(spec, batch, generator,
                                                training))

        B, T = full['left_eye_patch'].shape[:2]
        BT = B * T

        # A frozen EyeNet's stages keep no graph.
        eye_ctx = (torch.no_grad() if spec.eye_net_frozen
                   else contextlib.nullcontext())
        with eye_ctx:
            feats, rnn_l, rnn_r, final_states = self._eye_net_stages(
                full, B, T, initial_states)
            # --- Stage 3: heads ---
            g_l, pupil_l = eye_net.heads(rnn_l)
            g_r, pupil_r = eye_net.heads(rnn_r)
        interm = {
            'left_g_initial': g_l, 'right_g_initial': g_r,
            'left_pupil_size': pupil_l, 'right_pupil_size': pupil_r,
        }

        # Kappa offset augmentation needs the head rotation; the initial
        # losses then read the unaugmented branch.
        do_aug = (training and spec.refine_net_do_offset_augmentation and
                  'head_R' in full)
        if do_aug:
            for k, v in g_to_pog(spec, full, g_l, g_r).items():
                interm[k + '_initial_unaugmented'] = v
            interm['left_g_initial_unaugmented'] = g_l
            interm['right_g_initial_unaugmented'] = g_r
            g_l = geo.apply_offset_augmentation(
                g_l, full['head_R'], full['left_kappa_fake'])
            g_r = geo.apply_offset_augmentation(
                g_r, full['head_R'], full['right_kappa_fake'])
            interm['left_g_initial'] = g_l
            interm['right_g_initial'] = g_r
        # --- Projection and the initial heatmap ---
        for k, v in g_to_pog(spec, full, g_l, g_r).items():
            interm[k + '_initial'] = v

        # --- Stages 4-6: RefineNet ---
        if refine_net is not None and 'heatmap_initial' in interm:
            w, h = spec.gaze_heatmap_size
            screen = None
            if spec.load_screen_content:
                sf = _screen_to_float(full['screen_frame']).float()
                screen = _nhwc_to_nchw(sf.reshape((BT,) + sf.shape[2:]))
            net_in = refine_net.assemble_input(
                interm['heatmap_initial'].reshape(BT, h, w), screen,
                screen_size=spec.screen_size)
            bottleneck_in, skips = refine_net.encode(net_in)
            if spec.refine_net_use_rnn:
                if initial_states is not None and 'refine' in initial_states:
                    states = initial_states['refine']
                else:
                    states = refine_net.init_state(B, device=net_in.device)
                seq = bottleneck_in.reshape((B, T) + bottleneck_in.shape[1:])
                outs = []
                for t in range(T):
                    out, states = refine_net.bottleneck_step(seq[:, t], states)
                    outs.append(out)
                final_states['refine'] = states
                bottleneck_out = torch.stack(outs, dim=1).reshape(
                    bottleneck_in.shape)
            else:
                bottleneck_out = bottleneck_in
                final_states['refine'] = ()
            heatmap_final = refine_net.decode(bottleneck_out, skips)
            interm['heatmap_final'] = heatmap_final.reshape(B, T, h, w)
            interm['PoG_px_final'] = hm_ops.soft_argmax_fast(
                interm['heatmap_final'],
                heatmap_size=spec.gaze_heatmap_size,
                actual_screen_size=spec.actual_screen_size)
            cm_per_px = 0.1 * full['millimeters_per_pixel']
            interm['PoG_cm_final'] = interm['PoG_px_final'] * cm_per_px
            interm['g_final'] = geo.calculate_combined_gaze_direction(
                full['o'], 10.0 * interm['PoG_cm_final'],
                full['left_R'], full['camera_transformation'])

        # --- Outputs ---
        output = {'left_pupil_size': interm['left_pupil_size'],
                  'right_pupil_size': interm['right_pupil_size']}
        if output_predictions:
            for k in ('timestamps', 'o', 'left_R', 'head_R',
                      'millimeters_per_pixel', 'pixels_per_millimeter',
                      'camera_transformation', 'inv_camera_transformation'):
                if k in full:
                    output[k] = full[k]
            for k in ('g_initial', 'PoG_px_initial', 'PoG_cm_initial'):
                if k in interm:
                    output[k] = interm[k]
            if 'g' in full:
                output['g'] = full['g']
                output['validity'] = full['PoG_px_tobii_validity']
                output['PoG_cm'] = full['PoG_cm_tobii']
                output['PoG_px'] = full['PoG_px_tobii']
            if refine_net is not None:
                for k in ('g_final', 'PoG_px_final', 'PoG_cm_final'):
                    if k in interm:
                        output[k] = interm[k]

        calculate_losses_and_metrics(full, interm, output, do_aug)
        output['full_loss'] = _full_loss(spec, output, feats.device)
        if return_states:
            output['states'] = final_states
        return output

    def _eye_net_stages(self, full, B, T, initial_states):
        """Stages 1-2: ``(features, rnn_left, rnn_right, final_states)``."""
        spec = self.spec
        eye_net = self.eye_net
        BT = B * T
        nf = spec.eye_net_num_features
        left = full['left_eye_patch']

        # --- Stage 1: CNN features for all frames and both eyes ---
        patches = _nhwc_to_nchw(torch.cat([
            _to_compute(full['left_eye_patch']).reshape((BT,) + left.shape[2:]),
            _to_compute(full['right_eye_patch']).reshape((BT,) + left.shape[2:]),
        ], dim=0))
        head_pose = None
        if spec.eye_net_use_head_pose_input:
            head_pose = torch.cat([full['left_h'].reshape(BT, 2),
                                   full['right_h'].reshape(BT, 2)], dim=0)
        feats = eye_net.features(patches, head_pose)
        feats_l = feats[:BT].reshape(B, T, nf)
        feats_r = feats[BT:].reshape(B, T, nf)

        # --- Stage 2: the dense cell stack over T, both eyes stacked ---
        if spec.eye_net_use_rnn:
            if initial_states is not None:
                states = tree_map(lambda a, b: torch.cat([a, b], dim=0),
                                  initial_states['eye_left'],
                                  initial_states['eye_right'])
            else:
                states = eye_net.init_state(2 * B, device=feats.device)
            feats_lr = torch.cat([feats_l, feats_r], dim=0)   # (2B, T, F)
            outs = []
            for t in range(T):
                out, states = eye_net.recurrent(feats_lr[:, t], states)
                outs.append(out)
            out_lr = torch.stack(outs, dim=1)
            final_states = {'eye_left': tree_map(lambda a: a[:B], states),
                            'eye_right': tree_map(lambda a: a[B:], states)}
            rnn_l, rnn_r = out_lr[:B], out_lr[B:]
        else:
            rnn_l = eye_net.static_path(feats_l)
            rnn_r = eye_net.static_path(feats_r)
            final_states = {'eye_left': (), 'eye_right': ()}
        return feats, rnn_l, rnn_r, final_states


def init_weights(model, generator):
    """Fill every parameter of ``model`` with eve_tpu's initialisers.

    Drawn on ``generator`` (a CPU ``torch.Generator``) and copied to the
    parameters' device, so a seed gives the same weights on any device:

    - convolutions (cells' included): kaiming-normal, fan_out, relu gain,
      std sqrt(2 / (O * KH * KW)); zero bias;
    - linear layers: U(+-1/sqrt(fan_in)) for weight and bias;
    - dense RNN cells: U(+-1/sqrt(H)) for every parameter;
    - affine instance norms: ones and zeros;
    - EyeNet's ``fc_to_gaze.2`` and RefineNet's ``final.2``: zero.
    """
    def fill(p, sample):
        with torch.no_grad():
            p.copy_(sample(torch.empty(p.shape)))

    def uniform(bound):
        return lambda t: t.uniform_(-bound, bound, generator=generator)

    def zeros(t):
        return t.zero_()

    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            o, _, kh, kw = module.weight.shape
            std = math.sqrt(2.0 / (o * kh * kw))
            fill(module.weight,
                 lambda t: t.normal_(0.0, std, generator=generator))
            if module.bias is not None:
                fill(module.bias, zeros)
        elif isinstance(module, nn.Linear):
            bound = 1.0 / math.sqrt(module.in_features)
            fill(module.weight, uniform(bound))
            if module.bias is not None:
                fill(module.bias, uniform(bound))
        elif isinstance(module, nn.RNNCellBase):
            for p in module.parameters():
                fill(p, uniform(1.0 / math.sqrt(module.hidden_size)))
        elif isinstance(module, InstanceNorm) and module.weight is not None:
            fill(module.weight, lambda t: t.fill_(1.0))
            fill(module.bias, zeros)
    for module in model.modules():
        if isinstance(module, EyeNet):
            fill(module.fc_to_gaze[2].weight, zeros)
        elif isinstance(module, RefineNet):
            fill(module.final[2].weight, zeros)
            fill(module.final[2].bias, zeros)
    return model


def init_model(spec, generator, device='cuda'):
    """A freshly initialised ``EVE`` on ``device`` (see ``init_weights``).

    Built on the meta device and then filled, as ``build_model`` does.
    """
    with torch.device('meta'):
        model = EVE(spec)
    return init_weights(model.to_empty(device=device), generator)


def build_model(spec, state_dict, device='cuda'):
    """An ``EVE`` in eval mode on ``device`` holding ``state_dict`` (strict).

    The modules are built on the meta device and then filled, so no
    parameter is drawn at random on the way.
    """
    with torch.device('meta'):
        model = EVE(spec)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


# ----------------------------------------------------------------------
# Labels
# ----------------------------------------------------------------------

def draw_kappas(spec, batch_size, generator):
    """``(left, right)`` kappa offsets, (B, 2) float32 on the CPU.

    ``std * N(0, 1)`` per clip and eye, std the augmentation sigma in
    radians; with ``refine_net_offset_augmentation_zero_prob`` > 0 one
    keep/zero draw per clip, shared by both eyes. Drawn on a CPU generator,
    so a seed gives the same kappas whatever device the model runs on.
    """
    if generator is None or generator.device.type != 'cpu':
        raise ValueError('the kappa augmentation draws on a CPU '
                         'torch.Generator; got %r' % (generator,))
    std = math.radians(spec.refine_net_offset_augmentation_sigma)
    kappas = [std * torch.randn((batch_size, 2), generator=generator)
              for _ in range(2)]
    zp = float(spec.refine_net_offset_augmentation_zero_prob)
    if zp > 0.0:
        keep = (torch.rand((batch_size, 1), generator=generator)
                >= zp).float()
        kappas = [k * keep for k in kappas]
    return kappas


def calculate_additional_labels(spec, batch, generator=None, training=False):
    """Derive the labels eve_tpu computes on the fly.

    In training with the offset augmentation, the per-clip kappas
    (``left_kappa_fake``/``right_kappa_fake``, (B, T, 2)) are drawn on
    ``generator`` unless the batch carries both. The ground-truth heatmaps
    go through one launch of the render kernel on the card, all three
    sigmas and the validity mask at once.
    """
    labels = {}
    mm_per_px = batch.get('millimeters_per_pixel')
    for side in ('left', 'right'):
        k = side + '_PoG_tobii'
        if k in batch:
            labels[side + '_PoG_cm_tobii'] = batch[k] * 0.1 * mm_per_px
            labels[side + '_PoG_cm_tobii_validity'] = batch[k + '_validity']

    if training and spec.refine_net_do_offset_augmentation:
        if ('left_kappa_fake' in batch) != ('right_kappa_fake' in batch):
            raise ValueError('inject both left_kappa_fake and '
                             'right_kappa_fake, or neither')
        if 'left_kappa_fake' not in batch:
            B, T = batch['left_eye_patch'].shape[:2]
            device = batch['left_eye_patch'].device
            for side, kappa in zip(('left', 'right'),
                                   draw_kappas(spec, B, generator)):
                labels[side + '_kappa_fake'] = kappa.to(device)[:, None, :] \
                    .expand(B, T, 2)

    if 'left_o' in batch:
        labels['o'] = 0.5 * (batch['left_o'] + batch['right_o'])
        labels['o_validity'] = batch['left_o_validity']

    if 'left_PoG_tobii' in batch:
        labels['PoG_px_tobii'] = 0.5 * (batch['left_PoG_tobii'] +
                                        batch['right_PoG_tobii'])
        labels['PoG_cm_tobii'] = 0.5 * (labels['left_PoG_cm_tobii'] +
                                        labels['right_PoG_cm_tobii'])
        validity = (batch['left_PoG_tobii_validity'].bool() &
                    batch['right_PoG_tobii_validity'].bool())
        labels['PoG_px_tobii_validity'] = validity
        labels['PoG_cm_tobii_validity'] = validity

        if spec.refine_net_enabled:
            # The three ground-truth sigmas, masked, in one render launch.
            names = ('heatmap_initial', 'heatmap_history', 'heatmap_final')
            maps = hm_ops.make_heatmaps_multi_fast(
                labels['PoG_px_tobii'],
                (spec.gaze_heatmap_sigma_initial,
                 spec.gaze_heatmap_sigma_history,
                 spec.gaze_heatmap_sigma_final),
                multiplier=validity.float(),
                heatmap_size=spec.gaze_heatmap_size,
                actual_screen_size=spec.actual_screen_size)
            for name, hm in zip(names, maps):
                labels[name] = hm
                labels[name + '_validity'] = validity

    if 'PoG_cm_tobii' in labels:
        labels['g'] = geo.calculate_combined_gaze_direction(
            labels['o'], 10.0 * labels['PoG_cm_tobii'],
            batch['left_R'], batch['camera_transformation'])
        labels['g_validity'] = labels['PoG_cm_tobii_validity']
    return labels


def g_to_pog(spec, full, g_left, g_right):
    """Project per-eye gazes to the screen, average, derive combined gaze.

    With RefineNet enabled, also renders the initial-sigma heatmap at the
    mean PoG (the render kernel on the card).
    """
    out = {}
    if 'inv_camera_transformation' not in full:
        return out
    ref = {'inv_camera_transformation': full['inv_camera_transformation'],
           'pixels_per_millimeter': full['pixels_per_millimeter']}
    for side, g in (('left', g_left), ('right', g_right)):
        PoG_mm, PoG_px = geo.to_screen_coordinates(
            full[side + '_o'], g, full[side + '_R'], ref,
            actual_screen_size=spec.actual_screen_size)
        out[side + '_PoG_cm'] = 0.1 * PoG_mm
        out[side + '_PoG_px'] = PoG_px
    out['PoG_px'] = 0.5 * (out['left_PoG_px'] + out['right_PoG_px'])
    out['PoG_cm'] = 0.5 * (out['left_PoG_cm'] + out['right_PoG_cm'])
    out['PoG_mm'] = 10.0 * out['PoG_cm']
    out['g'] = geo.calculate_combined_gaze_direction(
        full['o'], out['PoG_mm'], full['left_R'],
        full['camera_transformation'])
    if spec.refine_net_enabled:
        out['heatmap'] = hm_ops.make_heatmaps_fast(
            out['PoG_px'], spec.gaze_heatmap_sigma_initial,
            heatmap_size=spec.gaze_heatmap_size,
            actual_screen_size=spec.actual_screen_size)
    return out


def init_stream_state(spec, batch_size, device=None):
    """Zero recurrent state for streaming (chunked) inference.

    ``{'eye_left', 'eye_right'[, 'refine']}``, each a tuple with one state
    per cell; conv states are NCHW (B, C, 5, 8).
    """
    def eye():
        if not spec.eye_net_use_rnn:
            return ()
        return tuple(zero_state(DENSE_CELLS[spec.eye_net_rnn_type],
                                spec.eye_net_num_features, batch_size,
                                device=device)
                     for _ in range(spec.eye_net_rnn_num_cells))

    state = {'eye_left': eye(), 'eye_right': eye()}
    if spec.refine_net_enabled:
        state['refine'] = () if not spec.refine_net_use_rnn else tuple(
            zero_state(CONV_CELLS[spec.refine_net_rnn_type],
                       spec.refine_net_num_features, batch_size,
                       hw=LEVEL_SHAPES[4], device=device)
            for _ in range(spec.refine_net_rnn_num_cells))
    return state


# ----------------------------------------------------------------------
# Losses and metrics
# ----------------------------------------------------------------------

def calculate_losses_and_metrics(full, interm, output, do_aug=False):
    """eve_tpu's losses and metrics.

    With the offset augmentation (``do_aug``) the initial losses read the
    *_unaugmented branch; without it the plain keys hold the predictions.
    """
    for side in ('left', 'right'):
        suffix = '_initial_unaugmented' if do_aug else '_initial'
        gt = side + '_g_tobii'
        pred_key = side + '_g' + suffix
        if pred_key in interm and gt in full:
            output['loss_ang_' + side + '_g_initial'] = \
                losses_lib.angular_loss(interm[pred_key], full[gt],
                                        full[gt + '_validity'])

        gt = side + '_PoG_cm_tobii'
        pred_key = side + '_PoG_cm' + suffix
        if pred_key in interm and gt in full:
            output['loss_mse_' + side + '_PoG_cm_initial'] = \
                losses_lib.mse_loss(interm[pred_key], full[gt],
                                    full[gt + '_validity'])
            output['metric_euc_' + side + '_PoG_cm_initial'] = \
                losses_lib.euclidean_loss(interm[pred_key], full[gt],
                                          full[gt + '_validity'])

        gt = side + '_PoG_tobii'
        pred_key = side + '_PoG_px_initial'
        if pred_key in interm and gt in full:
            output['metric_euc_' + pred_key] = losses_lib.euclidean_loss(
                interm[pred_key], full[gt], full[gt + '_validity'])

        gt = side + '_p'
        pred_key = side + '_pupil_size'
        if pred_key in interm and gt in full:
            output['loss_l1_' + pred_key] = losses_lib.l1_loss(
                interm[pred_key], full[gt], full[gt + '_validity'])

    if ('left_PoG_tobii' in full and 'right_PoG_tobii' in full and
            'left_PoG_cm_initial' in interm):
        lr_validity = (full['left_PoG_tobii_validity'].bool() &
                       full['right_PoG_tobii_validity'].bool())
        output['loss_mse_lr_consistency'] = losses_lib.mse_loss(
            interm['left_PoG_cm_initial'], interm['right_PoG_cm_initial'],
            lr_validity)
        output['metric_euc_lr_consistency'] = losses_lib.euclidean_loss(
            interm['left_PoG_cm_initial'], interm['right_PoG_cm_initial'],
            lr_validity)

    pred_key = 'heatmap_initial_unaugmented' if do_aug else 'heatmap_initial'
    if pred_key in interm and 'heatmap_initial' in full:
        output['loss_ce_heatmap_initial'] = losses_lib.cross_entropy_loss(
            interm[pred_key], full['heatmap_initial'],
            full['heatmap_initial_validity'])

    if 'heatmap_final' in interm and 'heatmap_final' in full:
        output['loss_ce_heatmap_final'] = losses_lib.cross_entropy_loss(
            interm['heatmap_final'], full['heatmap_final'],
            full['heatmap_final_validity'])
        output['loss_mse_heatmap_final'] = losses_lib.mse_loss(
            interm['heatmap_final'], full['heatmap_final'],
            full['heatmap_final_validity'])

    if do_aug:
        for pred_key, gt, fn, name in (
                ('PoG_px_initial_unaugmented', 'PoG_px_tobii',
                 losses_lib.euclidean_loss, 'metric_euc_'),
                ('PoG_cm_initial_unaugmented', 'PoG_cm_tobii',
                 losses_lib.euclidean_loss, 'metric_euc_'),
                ('g_initial_unaugmented', 'g',
                 losses_lib.angular_loss, 'metric_ang_')):
            if pred_key in interm and gt in full:
                output[name + pred_key] = fn(
                    interm[pred_key], full[gt], full[gt + '_validity'])

    for pred_key, gt in (('PoG_px_initial', 'PoG_px_tobii'),
                         ('PoG_cm_initial', 'PoG_cm_tobii'),
                         ('PoG_px_final', 'PoG_px_tobii'),
                         ('PoG_cm_final', 'PoG_cm_tobii')):
        if pred_key in interm and gt in full:
            output['loss_mse_' + pred_key] = losses_lib.mse_loss(
                interm[pred_key], full[gt], full[gt + '_validity'])
            output['metric_euc_' + pred_key] = losses_lib.euclidean_loss(
                interm[pred_key], full[gt], full[gt + '_validity'])

    for pred_key in ('g_initial', 'g_final'):
        if pred_key in interm and 'g' in full:
            output['metric_ang_' + pred_key] = losses_lib.angular_loss(
                interm[pred_key], full['g'], full['g_validity'])


def _full_loss(spec, output, device):
    """The weighted total of eve_tpu's ``full_loss``."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    if 'loss_ang_left_g_initial' in output:
        total = total + spec.loss_coeff_g_ang_initial * (
            output['loss_ang_left_g_initial'] +
            output['loss_ang_right_g_initial'])
    if 'loss_mse_left_PoG_cm_initial' in output and \
            spec.loss_coeff_PoG_cm_initial > 0.0:
        total = total + spec.loss_coeff_PoG_cm_initial * (
            output['loss_mse_left_PoG_cm_initial'] +
            output['loss_mse_right_PoG_cm_initial'])
    if 'loss_l1_left_pupil_size' in output:
        total = total + spec.loss_coeff_pupil_size * (
            output['loss_l1_left_pupil_size'] +
            output['loss_l1_right_pupil_size'])
    for key, coeff in (
            ('loss_mse_PoG_cm_final', spec.loss_coeff_PoG_cm_final),
            ('loss_ce_heatmap_initial', spec.loss_coeff_heatmap_ce_initial),
            ('loss_ce_heatmap_final', spec.loss_coeff_heatmap_ce_final),
            ('loss_mse_heatmap_final', spec.loss_coeff_heatmap_mse_final)):
        if key in output:
            total = total + coeff * output[key]
    return total
