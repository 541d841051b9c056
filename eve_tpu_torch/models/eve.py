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
float frames; the NHWC -> NCHW permute happens once, here: a contiguous
copy, or, where the networks run channels-last (bfloat16 on the card,
``layers.runs_channels_last``), the permuted view itself, whose storage is
already channels-last. Output, loss and metric names are eve_tpu's.

``forward(training=True, generator=...)`` is eve_tpu's training forward:
the initial gazes get a kappa offset (``std * N(0, 1)`` per clip and eye,
drawn on a CPU ``torch.Generator`` so that the card and the CPU draw the
same kappas, or injected as ``left_kappa_fake``/``right_kappa_fake``), and
the initial losses read the unaugmented ``*_unaugmented`` branch. With
``eye_net_frozen`` EyeNet's parameters do not require gradients and its
stages run under ``torch.no_grad()``.

``forward(create_images=True)`` adds eve_tpu's image outputs: the last
frame's screen, initial, refined and ground-truth heatmaps, and, with
labels, the decayed gaze histories. The history-sigma map of the initial
estimate is rendered in the same launch as the initial heatmap (a second
sigma), so the render still launches once for the estimate and once for
the labels.

``EveSpec.compute_dtype`` 'bfloat16' runs the networks in bfloat16 (any
other value runs float32, as in eve_tpu), with eve_tpu's casts: eye frames
are normalised in float32 and cast before they are stacked; ResNet-18 and
RefineNet compute in bfloat16 and return float32 (see their modules);
``fc_common``, the dense cells and the heads run float32; the RefineNet
states are bfloat16. The parameters, the geometry, the losses, both heatmap
kernels and the soft-argmax stay float32.

``EveSpec.tpu_native_arch`` builds eve_tpu's opt-in topology: the patchify
EyeNet stem (``tpu_native_stem``, see ``resnet``) and ``RefineNetTPU``
(``refine_net_tpu``). Its ``tpu_native_refine_head`` 'gated' readout keeps
the soft-argmax's reading as ``PoG_px_heatmap_final`` and returns
``PoG_px_final = initial + gate * (heatmap - initial) + delta``, with the
gate as ``refine_gate`` and two metrics that never enter ``full_loss``.

``EveSpec.remat`` (eve_tpu's ``tpu_remat``) recomputes EyeNet's ResNet
features ('eye'), RefineNet's encoder ('refine') or both ('all') in the
backward pass instead of keeping their activations
(``torch.utils.checkpoint``, as eve_tpu's ``jax.checkpoint``). It applies
only to a training forward that records a graph: inference, and 'eye'
under a frozen EyeNet (whose stages keep no graph), are unchanged.

``forward(seq_group=...)`` is eve_tpu's ``forward(seq_mesh=...)``: the
batch holds this seq rank's frames of its clips (``parallel.temporal.
local_frames``), the two loops (the GRU's, the CLSTM's) run as the rank's
part of a scan over the whole clips (``temporal.scan_shard``: the carry
comes from the previous rank and goes to the next, in the forward and,
reversed, in the backward pass), and every loss and metric is the whole
clips' (``losses.masked_mean`` sums each clip's terms over the axis).
Every other stage runs on the rank's own frames. The final states are
replicated over the axis when ``return_states`` asks for them.
"""

import contextlib
import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from eve_tpu_torch import losses as losses_lib
from eve_tpu_torch.models import layers
from eve_tpu_torch.models.cells import CONV_CELLS, DENSE_CELLS, zero_state
from eve_tpu_torch.models.eye_net import EyeNet
from eve_tpu_torch.models.layers import InstanceNorm
from eve_tpu_torch.models.refine_net import LEVEL_SHAPES, RefineNet
from eve_tpu_torch.models.refine_net_tpu import RefineNetTPU
from eve_tpu_torch.ops import geometry as geo
from eve_tpu_torch.ops import heatmap as hm_ops
from eve_tpu_torch.parallel import temporal
# Re-exported: callers take them from here, as from eve_tpu's module.
from eve_tpu_torch.utils.tensors import (  # noqa: F401
    batch_to_tensors, tree_map)


@dataclasses.dataclass(frozen=True)
class EveSpec:
    """Static model specification: the fields of eve_tpu's ``EveSpec`` that
    the port reads."""
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
    gaze_history_map_decay_per_ms: float = 0.999
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
    # Compute type of the networks: 'bfloat16', or float32 for any other
    # value (eve_tpu's rule)
    compute_dtype: str = 'float32'
    # eve_tpu's opt-in topology (not weight-compatible with the reference):
    # the EyeNet stem 'patchify' (8x8/4) or 'patchify8' (8x8/8), and
    # RefineNetTPU with the 'heatmap' or 'gated' readout. The stem and the
    # readout are ignored without tpu_native_arch.
    tpu_native_arch: bool = False
    tpu_native_stem: str = 'patchify'
    tpu_native_refine_head: str = 'heatmap'
    # Rematerialisation in training: 'none', 'eye' (ResNet features),
    # 'refine' (RefineNet encoder) or 'all'; eve_tpu's booleans mean 'all'
    # and 'none'.
    remat: object = 'none'

    @property
    def remat_eye(self):
        return self.remat in (True, 'all', 'eye')

    @property
    def remat_refine(self):
        return self.remat in (True, 'all', 'refine')

    @property
    def dtype(self):
        """The networks' torch compute type."""
        return (torch.bfloat16 if self.compute_dtype == 'bfloat16'
                else torch.float32)

    @property
    def gated(self):
        """Whether RefineNet has the residual 'gated' readout."""
        return (self.refine_net_enabled and self.tpu_native_arch and
                self.tpu_native_refine_head == 'gated')

    def __post_init__(self):
        """eve_tpu's ``ValueError``s for ``tpu_native_refine_head``, which
        it raises when it builds the RefineNet."""
        head = self.tpu_native_refine_head
        if not self.refine_net_enabled or head == 'heatmap':
            return
        if head != 'gated':
            raise ValueError(
                "Unknown tpu_native_refine_head %r (expected 'heatmap' or "
                "'gated')" % (head,))
        if not self.tpu_native_arch:
            raise ValueError(
                "tpu_native_refine_head='gated' requires tpu_native_arch "
                "(the reference topology keeps the reference readout)")

    @classmethod
    def from_config(cls, config):
        """Build from an ``eve_tpu_torch.config.Config``."""
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
            gaze_history_map_decay_per_ms=(
                config.gaze_history_map_decay_per_ms),
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
            tpu_native_arch=config.tpu_native_arch,
            tpu_native_stem=config.tpu_native_stem,
            tpu_native_refine_head=config.tpu_native_refine_head,
            remat=config.tpu_remat,
        )


def _to_compute(x, dtype):
    """Camera frames to ``dtype``; uint8 gets ``*2/255-1`` in float32 on
    the device first."""
    if x.dtype == torch.uint8:
        return (x.float() * (2.0 / 255.0) - 1.0).to(dtype)
    return x.to(dtype)


def _screen_to_float(x):
    """Screen frames: uint8 -> [0, 1] float32 on the device."""
    if x is not None and x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x


def _checkpointed(fn, enabled):
    """``fn``, recomputed in the backward pass (``torch.utils.checkpoint``)
    when ``enabled`` and a graph is being recorded; else ``fn`` itself.
    The wrapped stages draw no random numbers, so no RNG state is kept."""
    if not (enabled and torch.is_grad_enabled()):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, preserve_rng_state=False)


def _nhwc_to_nchw(x, dtype):
    """(N, H, W, C) -> (N, C, H, W) for a network computing in ``dtype``:
    channels-last where ``layers.runs_channels_last`` holds (the permuted
    view of a contiguous NHWC tensor already is), else contiguous."""
    return x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last if layers.runs_channels_last(
            dtype, x.device) else torch.contiguous_format)


class EVE(nn.Module):
    """EyeNet (``eye_net``) and, when enabled, RefineNet (``refine_net``)."""

    def __init__(self, spec: EveSpec):
        super().__init__()
        self.spec = spec
        self.eye_net = EyeNet(
            num_features=spec.eye_net_num_features,
            use_rnn=spec.eye_net_use_rnn,
            rnn_type=spec.eye_net_rnn_type,
            rnn_num_cells=spec.eye_net_rnn_num_cells,
            use_head_pose_input=spec.eye_net_use_head_pose_input,
            compute_dtype=spec.dtype,
            stem=(spec.tpu_native_stem if spec.tpu_native_arch
                  else 'reference'))
        self.refine_net = None
        if spec.refine_net_enabled:
            if spec.tpu_native_arch:
                cls, kw = RefineNetTPU, {
                    'readout': spec.tpu_native_refine_head}
            else:
                cls, kw = RefineNet, {}
            self.refine_net = cls(
                load_screen_content=spec.load_screen_content,
                use_skip_connections=spec.refine_net_use_skip_connections,
                use_rnn=spec.refine_net_use_rnn,
                rnn_type=spec.refine_net_rnn_type,
                rnn_num_cells=spec.refine_net_rnn_num_cells,
                num_features=spec.refine_net_num_features,
                clstm_carry_only=spec.clstm_carry_only,
                compute_dtype=spec.dtype, **kw)
        if spec.eye_net_frozen:
            # As the reference freezes it: no gradient, no optimizer state.
            self.eye_net.requires_grad_(False)

    def forward(self, batch, training=False, generator=None,
                output_predictions=False, create_images=False,
                initial_states=None, return_states=False, seq_group=None):
        """Full EVE forward over a (B, T, ...) clip batch of tensors.

        Returns the output dict of losses, metrics and (optionally)
        predictions, with eve_tpu's key names; ``create_images`` adds the
        image outputs (see the module docstring); ``return_states`` adds the
        final recurrent states (see ``init_stream_state``) under 'states'.
        ``training`` turns on the kappa offset augmentation, whose kappas
        are drawn on ``generator`` (a CPU ``torch.Generator``) unless the
        batch carries ``left_kappa_fake`` and ``right_kappa_fake``.
        ``seq_group`` (a ``parallel.mesh.Axis``) splits the clips' frames
        over its ranks (see the module docstring).
        """
        spec = self.spec
        if seq_group is not None and seq_group.size == 1:
            seq_group = None
        if seq_group is not None and create_images:
            raise ValueError('create_images needs whole clips; it does not '
                             'run under a seq_group')
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
                full, B, T, initial_states, training, seq_group,
                return_states)
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
        # The gaze history is a visualisation of labelled clips only.
        history = (create_images and spec.refine_net_enabled and
                   'PoG_px_tobii' in full)
        for k, v in g_to_pog(spec, full, g_l, g_r,
                             with_history=history).items():
            interm[k + '_initial'] = v
        if 'heatmap_history_initial' in interm:
            interm['history_initial'] = hm_ops.decayed_history_scan(
                interm.pop('heatmap_history_initial'),
                full['timestamps'].float(),
                full['PoG_px_tobii_validity'].float(),
                decay_per_ms=spec.gaze_history_map_decay_per_ms)

        # --- Stages 4-6: RefineNet ---
        if refine_net is not None and 'heatmap_initial' in interm:
            w, h = spec.gaze_heatmap_size
            screen = None
            if spec.load_screen_content:
                sf = _screen_to_float(full['screen_frame']).to(spec.dtype)
                screen = _nhwc_to_nchw(sf.reshape((BT,) + sf.shape[2:]),
                                       spec.dtype)
            net_in = refine_net.assemble_input(
                interm['heatmap_initial'].reshape(BT, h, w), screen,
                screen_size=spec.screen_size)
            bottleneck_in, skips = _checkpointed(
                refine_net.encode, training and spec.remat_refine)(net_in)
            if spec.refine_net_use_rnn:
                if initial_states is not None and 'refine' in initial_states:
                    states = initial_states['refine']
                else:
                    states = refine_net.init_state(B, device=net_in.device)
                seq = bottleneck_in.reshape((B, T) + bottleneck_in.shape[1:])
                states, bottleneck_out = _scan(
                    lambda c, x: refine_net.bottleneck_step(x, c)[::-1],
                    states, seq, seq_group, 'refine',
                    refine_net.parameters(), return_states)
                final_states['refine'] = states
                bottleneck_out = bottleneck_out.reshape(bottleneck_in.shape)
            else:
                bottleneck_out = bottleneck_in
                final_states['refine'] = ()
            if spec.gated:
                heatmap_final, gate, delta = refine_net.decode_readout(
                    bottleneck_out, skips)
            else:
                heatmap_final = refine_net.decode(bottleneck_out, skips)
            interm['heatmap_final'] = heatmap_final.reshape(B, T, h, w)
            interm['PoG_px_final'] = hm_ops.soft_argmax_fast(
                interm['heatmap_final'],
                heatmap_size=spec.gaze_heatmap_size,
                actual_screen_size=spec.actual_screen_size)
            if spec.gated:
                # The residual readout: the soft-argmax proposes a step
                # from the (in training, augmented) initial estimate, the
                # gate says how far to take it and delta adds a sub-cell
                # correction.
                initial = interm['PoG_px_initial']
                heatmap_pog = interm['PoG_px_final']
                gate = gate.reshape(B, T, 2)
                interm['PoG_px_heatmap_final'] = heatmap_pog
                interm['PoG_px_final'] = (initial + gate * (
                    heatmap_pog - initial) + delta.reshape(B, T, 2))
                interm['refine_gate'] = gate
            cm_per_px = 0.1 * full['millimeters_per_pixel']
            interm['PoG_cm_final'] = interm['PoG_px_final'] * cm_per_px
            interm['g_final'] = geo.calculate_combined_gaze_direction(
                full['o'], 10.0 * interm['PoG_cm_final'],
                full['left_R'], full['camera_transformation'])
            if history:
                # The refined history accumulates the refined heatmaps
                # themselves, the initial one history-sigma Gaussians.
                interm['history_final'] = hm_ops.decayed_history_scan(
                    interm['heatmap_final'].float(),
                    full['timestamps'].float(),
                    full['PoG_px_tobii_validity'].float(),
                    decay_per_ms=spec.gaze_history_map_decay_per_ms)

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
        if create_images:
            output.update(image_outputs(spec, full, interm))

        calculate_losses_and_metrics(full, interm, output, do_aug, seq_group)
        output['full_loss'] = _full_loss(spec, output, feats.device)
        if return_states:
            output['states'] = final_states
        return output

    def _eye_net_stages(self, full, B, T, initial_states, training=False,
                        seq_group=None, return_states=False):
        """Stages 1-2: ``(features, rnn_left, rnn_right, final_states)``."""
        spec = self.spec
        eye_net = self.eye_net
        BT = B * T
        nf = spec.eye_net_num_features
        left = full['left_eye_patch']

        # --- Stage 1: CNN features for all frames and both eyes ---
        # Cast before the stack, as eve_tpu: the copy moves the compute
        # type's bytes.
        patches = _nhwc_to_nchw(torch.cat([
            _to_compute(full[k], spec.dtype).reshape((BT,) + left.shape[2:])
            for k in ('left_eye_patch', 'right_eye_patch')], dim=0),
            spec.dtype)
        head_pose = None
        if spec.eye_net_use_head_pose_input:
            head_pose = torch.cat([full['left_h'].reshape(BT, 2),
                                   full['right_h'].reshape(BT, 2)], dim=0)
        feats = _checkpointed(eye_net.features,
                              training and spec.remat_eye)(patches,
                                                           head_pose)
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
            states, out_lr = _scan(
                lambda c, x: eye_net.recurrent(x, c)[::-1], states, feats_lr,
                seq_group, 'eye', eye_net.rnn_cells.parameters(),
                return_states)
            final_states = {'eye_left': tree_map(lambda a: a[:B], states),
                            'eye_right': tree_map(lambda a: a[B:], states)}
            rnn_l, rnn_r = out_lr[:B], out_lr[B:]
        else:
            rnn_l = eye_net.static_path(feats_l)
            rnn_r = eye_net.static_path(feats_r)
            final_states = {'eye_left': (), 'eye_right': ()}
        return feats, rnn_l, rnn_r, final_states


def _scan(step_fn, states, seq, seq_group, chain, params, return_states):
    """A loop over dim 1 of ``seq``: ``(final states, outputs stacked on
    dim 1)``; under a ``seq_group`` this rank's part of the loop over the
    whole clips (``temporal.scan_shard``)."""
    if seq_group is not None:
        return temporal.scan_shard(step_fn, states, seq, seq_group, chain,
                                   list(params), time_dim=1,
                                   replicate_final=return_states)
    outs = []
    for t in range(seq.shape[1]):
        states, out = step_fn(states, seq[:, t])
        outs.append(out)
    return states, torch.stack(outs, dim=1)


def init_weights(model, generator):
    """Fill every parameter of ``model`` with eve_tpu's initialisers.

    Drawn on ``generator`` (a CPU ``torch.Generator``) and copied to the
    parameters' device, so a seed gives the same weights on any device:

    - convolutions (cells' included): kaiming-normal, fan_out, relu gain,
      std sqrt(2 / (O * KH * KW)); zero bias;
    - linear layers: U(+-1/sqrt(fan_in)) for weight and bias;
    - dense RNN cells: U(+-1/sqrt(H)) for every parameter;
    - affine instance norms: ones and zeros;
    - EyeNet's ``fc_to_gaze.2`` and RefineNet's ``final.2``: zero;
    - RefineNetTPU's ``final_2`` and ``gate_fc2``: zero; ``gate_fc1`` is a
      flax ``nn.Dense`` in eve_tpu, so lecun-normal (a normal truncated at
      two standard deviations, scaled to variance 1 / fan_in) and a zero
      bias.
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
        elif isinstance(module, RefineNetTPU):
            for zero in [module.final_2] + (
                    [module.gate_fc2] if module.readout == 'gated' else []):
                fill(zero.weight, zeros)
                fill(zero.bias, zeros)
            if module.readout == 'gated':
                fc1 = module.gate_fc1
                # flax's truncated_normal stddev correction for [-2, 2].
                std = math.sqrt(1.0 / fc1.in_features) / .87962566103423978
                fill(fc1.weight, lambda t: nn.init.trunc_normal_(
                    t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))
                fill(fc1.bias, zeros)
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


def image_outputs(spec, full, interm):
    """eve_tpu's ``create_images`` outputs: the last frame's maps, the
    gazes and the ground truth."""
    out = {}
    if spec.load_screen_content and 'screen_frame' in full:
        out['screen_frame'] = _screen_to_float(full['screen_frame'][:, -1])
    for name, key in (('initial_gaze_history', 'history_initial'),
                      ('initial_heatmap', 'heatmap_initial'),
                      ('final_heatmap', 'heatmap_final'),
                      ('refined_gaze_history', 'history_final')):
        if key in interm:
            out[name] = interm[key][:, -1]
    if 'heatmap_final' in full:
        out['gt_heatmap'] = full['heatmap_final'][:, -1]
    if 'left_g_tobii' in full:
        out['left_g_gt'] = full['left_g_tobii']
        out['PoG_px_gt'] = full.get('PoG_px_tobii')
        out['PoG_px_gt_validity'] = full.get('PoG_px_tobii_validity')
    out['left_g_initial'] = interm['left_g_initial']
    if 'PoG_px_initial' in interm:
        out['PoG_px_initial'] = interm['PoG_px_initial']
    if 'g_final' in interm:
        out['g_final'] = interm['g_final']
        out['PoG_px_final'] = interm['PoG_px_final']
    return {k: v for k, v in out.items() if v is not None}


def g_to_pog(spec, full, g_left, g_right, with_history=False):
    """Project per-eye gazes to the screen, average, derive combined gaze.

    With RefineNet enabled, also renders the initial-sigma heatmap at the
    mean PoG (the render kernel on the card); ``with_history`` renders the
    history-sigma map (``heatmap_history``) in the same launch.
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
        sigmas = (spec.gaze_heatmap_sigma_initial,)
        if with_history:
            sigmas += (spec.gaze_heatmap_sigma_history,)
        maps = hm_ops.make_heatmaps_multi_fast(
            out['PoG_px'], sigmas, heatmap_size=spec.gaze_heatmap_size,
            actual_screen_size=spec.actual_screen_size)
        out['heatmap'] = maps[0]
        if with_history:
            out['heatmap_history'] = maps[1]
    return out


def init_stream_state(spec, batch_size, device=None):
    """Zero recurrent state for streaming (chunked) inference.

    ``{'eye_left', 'eye_right'[, 'refine']}``, each a tuple with one state
    per cell; conv states are NCHW (B, C, 5, 8). The EyeNet states are
    float32, the RefineNet states of the compute type.
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
                       hw=LEVEL_SHAPES[4], device=device, dtype=spec.dtype)
            for _ in range(spec.refine_net_rnn_num_cells))
    return state


# ----------------------------------------------------------------------
# Losses and metrics
# ----------------------------------------------------------------------

def calculate_losses_and_metrics(full, interm, output, do_aug=False,
                                 seq=None):
    """eve_tpu's losses and metrics.

    With the offset augmentation (``do_aug``) the initial losses read the
    *_unaugmented branch; without it the plain keys hold the predictions.
    Under ``seq`` (a seq axis) each is the whole clips' on every rank: the
    masked means sum their per-clip terms over the axis before dividing
    (``losses.masked_mean``).
    """
    for side in ('left', 'right'):
        suffix = '_initial_unaugmented' if do_aug else '_initial'
        gt = side + '_g_tobii'
        pred_key = side + '_g' + suffix
        if pred_key in interm and gt in full:
            output['loss_ang_' + side + '_g_initial'] = \
                losses_lib.angular_loss(interm[pred_key], full[gt],
                                        full[gt + '_validity'], seq=seq)

        gt = side + '_PoG_cm_tobii'
        pred_key = side + '_PoG_cm' + suffix
        if pred_key in interm and gt in full:
            output['loss_mse_' + side + '_PoG_cm_initial'] = \
                losses_lib.mse_loss(interm[pred_key], full[gt],
                                    full[gt + '_validity'], seq=seq)
            output['metric_euc_' + side + '_PoG_cm_initial'] = \
                losses_lib.euclidean_loss(interm[pred_key], full[gt],
                                          full[gt + '_validity'], seq=seq)

        gt = side + '_PoG_tobii'
        pred_key = side + '_PoG_px_initial'
        if pred_key in interm and gt in full:
            output['metric_euc_' + pred_key] = losses_lib.euclidean_loss(
                interm[pred_key], full[gt], full[gt + '_validity'], seq=seq)

        gt = side + '_p'
        pred_key = side + '_pupil_size'
        if pred_key in interm and gt in full:
            output['loss_l1_' + pred_key] = losses_lib.l1_loss(
                interm[pred_key], full[gt], full[gt + '_validity'], seq=seq)

    if ('left_PoG_tobii' in full and 'right_PoG_tobii' in full and
            'left_PoG_cm_initial' in interm):
        lr_validity = (full['left_PoG_tobii_validity'].bool() &
                       full['right_PoG_tobii_validity'].bool())
        output['loss_mse_lr_consistency'] = losses_lib.mse_loss(
            interm['left_PoG_cm_initial'], interm['right_PoG_cm_initial'],
            lr_validity, seq=seq)
        output['metric_euc_lr_consistency'] = losses_lib.euclidean_loss(
            interm['left_PoG_cm_initial'], interm['right_PoG_cm_initial'],
            lr_validity, seq=seq)

    pred_key = 'heatmap_initial_unaugmented' if do_aug else 'heatmap_initial'
    if pred_key in interm and 'heatmap_initial' in full:
        output['loss_ce_heatmap_initial'] = losses_lib.cross_entropy_loss(
            interm[pred_key], full['heatmap_initial'],
            full['heatmap_initial_validity'], seq=seq)

    if 'heatmap_final' in interm and 'heatmap_final' in full:
        output['loss_ce_heatmap_final'] = losses_lib.cross_entropy_loss(
            interm['heatmap_final'], full['heatmap_final'],
            full['heatmap_final_validity'], seq=seq)
        output['loss_mse_heatmap_final'] = losses_lib.mse_loss(
            interm['heatmap_final'], full['heatmap_final'],
            full['heatmap_final_validity'], seq=seq)

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
                    interm[pred_key], full[gt], full[gt + '_validity'],
                    seq=seq)

    for pred_key, gt in (('PoG_px_initial', 'PoG_px_tobii'),
                         ('PoG_cm_initial', 'PoG_cm_tobii'),
                         ('PoG_px_final', 'PoG_px_tobii'),
                         ('PoG_cm_final', 'PoG_cm_tobii')):
        if pred_key in interm and gt in full:
            output['loss_mse_' + pred_key] = losses_lib.mse_loss(
                interm[pred_key], full[gt], full[gt + '_validity'], seq=seq)
            output['metric_euc_' + pred_key] = losses_lib.euclidean_loss(
                interm[pred_key], full[gt], full[gt + '_validity'], seq=seq)

    for pred_key in ('g_initial', 'g_final'):
        if pred_key in interm and 'g' in full:
            output['metric_ang_' + pred_key] = losses_lib.angular_loss(
                interm[pred_key], full['g'], full['g_validity'], seq=seq)

    # The gated readout's diagnostics, metrics only: the heatmap's own
    # reading and the mean gate.
    if 'PoG_px_heatmap_final' in interm and 'PoG_px_tobii' in full:
        output['metric_euc_PoG_px_heatmap_final'] = \
            losses_lib.euclidean_loss(interm['PoG_px_heatmap_final'],
                                      full['PoG_px_tobii'],
                                      full['PoG_px_tobii_validity'], seq=seq)
    if 'refine_gate' in interm:
        # Every rank holds as many frames: the mean of the ranks' means.
        gate = temporal.seq_sum(interm['refine_gate'].mean(), seq)
        output['metric_mean_refine_gate'] = gate / (seq.size if seq else 1)


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
