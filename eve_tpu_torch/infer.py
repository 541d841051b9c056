"""Inference harness: single-video dataset, weight loading, eval iterator.

The counterpart of ``eve_tpu/infer.py`` (the reference's
src/core/inference.py:40-127): the hard config overrides of the inference
entry point, the input-path parsing into (participant, stimulus, camera), a
batch-1 dataset over that one video, weights from ``--resume-from`` or the
released reference weights, and an iterator that runs the model under
``torch.inference_mode`` and yields numpy dicts.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``.
``iterator(mesh=...)`` evaluates data-parallel over a
``parallel.mesh.DataMesh`` in this process: the model is replicated to
each device and every batch split into equal row slices, one a device.
"""

import logging
import os

import torch

from eve_tpu_torch import tracing
from eve_tpu_torch.cli import common
from eve_tpu_torch.data.dataset import EVESequencesBase
from eve_tpu_torch.data.loader import (DataLoader, DevicePrefetcher,
                                       split_host_batch)
from eve_tpu_torch.models import eve as eve_lib
from eve_tpu_torch.models import gaze360, zoo
from eve_tpu_torch.parallel import mesh as mesh_lib
from eve_tpu_torch.utils import checkpoint, convert, load_model

logger = logging.getLogger(__name__)

def script_init_common(argv=None):
    """``(config, args)`` of the inference CLI: the full pipeline, with the
    full screen recording for the overlay, unless flags say otherwise."""
    config, args = common.parse_config(
        argv, 'Run EVE inference on a video.', defaults={
            'fully_reproducible': True, 'refine_net_enabled': True,
            'load_screen_content': True,
            'load_full_frame_for_visualization': True})
    if not os.path.isfile(config.input_path):
        raise FileNotFoundError('--input-path %r is not a file'
                                % config.input_path)
    if not config.output_path:
        raise ValueError('--output-path is required')
    return config, args


def init_dataset(config):
    """The clips of the one video ``config.input_path`` names
    (``<root>/<participant>/<stimulus folder>/<camera>[_eyes|_face].mp4``),
    in order, one clip a batch."""
    components = config.input_path.split('/')
    person_id = components[-3]
    stimulus_type = components[-2].split('_')[1]
    camera_type = components[-1][:-4]
    for suffix in ('_eyes', '_face'):
        if camera_type.endswith(suffix):
            camera_type = camera_type[:-len(suffix)]
    if stimulus_type not in ('image', 'video', 'wikipedia'):
        raise ValueError('unknown stimulus type %r in %s'
                         % (stimulus_type, config.input_path))
    if camera_type not in ('webcam_l', 'webcam_c', 'webcam_r', 'basler'):
        raise ValueError('unknown camera %r in %s'
                         % (camera_type, config.input_path))

    dataset = EVESequencesBase(
        config.datasrc_eve, config=config,
        participants_to_use=[person_id],
        cameras_to_use=[camera_type],
        types_of_stimuli=[stimulus_type],
        stimulus_name_includes=components[-2])
    dataloader = DataLoader(dataset, batch_size=1, shuffle=False,
                            drop_last=False, num_workers=2)
    return dataset, dataloader


def model_setup(config, require_weights=False, device='cuda',
                pretrained_dir=None):
    """An ``EVE`` in eval mode on ``device``, with weights from a run
    directory or the released weights; under ``gaze_net`` 'gaze360' a
    ``Gaze360`` (``models.gaze360.model_setup``).

    With ``resume_from`` the newest checkpoint of that run directory (in
    eve_tpu's layout) loads; a submodule without a file keeps eve_tpu's
    seed-0 initialisation, as in eve_tpu. Otherwise each submodule loads
    from ``utils.load_model``; ``require_weights=True`` raises unless every
    enabled submodule found its file, instead of running random weights.
    """
    if zoo.gaze_net(config) == 'gaze360':
        return gaze360.model_setup(config, require_weights, device,
                                   pretrained_dir)
    spec = eve_lib.EveSpec.from_config(config)
    model = eve_lib.init_model(spec, torch.Generator().manual_seed(0),
                               device)
    submodules = [n for n in load_model.SUBMODULES
                  if getattr(model, n) is not None]
    if config.resume_from:
        if not os.path.isdir(config.resume_from):
            raise FileNotFoundError(config.resume_from)
        params, step = checkpoint.load_last_params(config.resume_from)
        for which in submodules:
            if which not in params:
                logger.warning('checkpoint %d of %s has no %s parameters',
                               step, config.resume_from, which)
                continue
            getattr(model, which).load_state_dict(
                convert.submodule_state_dict(which, params[which]),
                strict=True)
        logger.info('Loaded checkpoint %d of %s', step, config.resume_from)
    else:
        logger.info('Loading default weights if possible '
                    '(no --resume-from specified).')
        missing = [which for which in submodules
                   if not load_model.load_pretrained_into(
                       model, config, which, pretrained_dir)]
        if require_weights and missing:
            raise RuntimeError(
                'No %s weights: pass --resume-from <run_dir> or place the '
                'released weights under $EVE_PRETRAINED_DIR (refusing to '
                'run randomly initialized parameters).' % ' + '.join(missing))
    return model.eval()


def iterator(model, dataloader, create_images=True, streaming=False,
             materialize_inputs=True, mesh=None):
    """Yield ``(step, inputs_np, outputs_np)`` per batch.

    ``streaming=True`` carries the recurrent states from one batch to the
    next, which is right when the loader yields consecutive clips of one
    video in order at batch size 1 (the inference CLI's loader does): the
    results equal one forward over the whole video.

    ``materialize_inputs=False`` returns only the host-side extras (the
    strings, the int64 ``*_ns`` stamps) as inputs; otherwise the host
    arrays that were copied to the device come too (nothing is copied
    back). The output ``timestamps`` are the host's int64 nanoseconds. A
    ragged final batch runs at its own size.

    ``mesh``: a ``DataMesh`` (or a device count) evaluates data-parallel,
    eve_tpu's ``iterator(mesh=)``: the model is replicated to each device,
    each batch split into equal contiguous row slices, every slice's
    forward launched on its device before any output is read, and the
    outputs joined in row order (0-dim ones averaged). The loader's
    ``batch_size`` must divide by the mesh; a ragged final batch is padded
    with copies of its last clip, run, and cut. Not with ``streaming``.

    Without ``streaming``, a mesh or ``materialize_inputs`` (the
    evaluation CLI's call) the copy-in is ``DevicePrefetcher``'s: each
    batch is staged in pinned host memory and copied on a side stream by
    the prefetcher's thread while the device runs the batches before it.

    While a torch profiler records, each batch's work up to its yield is
    an ``infer.batch`` span (``eve_tpu_torch.tracing``) with ``infer.h2d``
    (the copy in; with the prefetcher, the wait for the next batch's
    staged inputs) and ``infer.d2h`` (the outputs' copy back) children.
    """
    device = next(model.parameters()).device
    mesh = mesh_lib.as_mesh(mesh, device)
    replicas = full = None
    if mesh is not None:
        if streaming:
            raise ValueError('mesh evaluation is batch-parallel; streaming '
                             'inference runs one clip (batch_size=1)')
        full = getattr(dataloader, 'batch_size', 0) or 0
        if not full:
            raise ValueError(
                'mesh evaluation requires the dataloader to expose a '
                'positive batch_size attribute (needed to pad ragged final '
                'batches to a shardable shape)')
        if full % mesh.size:
            raise ValueError('eval batch_size=%d must divide by the '
                             '%d-device %r mesh axis'
                             % (full, mesh.size, mesh.axis_names[0]))
        replicas = mesh_lib.replicate(mesh, model)
    if streaming and isinstance(model.spec, gaze360.GazeSpec):
        raise ValueError('Gaze360 cannot stream: its output at frame t '
                         'reads frames up to t+3 (a 3-frame look-ahead)')
    if mesh is None and not streaming and not materialize_inputs:
        yield from _prefetched(model, dataloader, device, create_images)
        return
    states = None
    for current_step, batch in enumerate(dataloader):
        with tracing.span('infer.batch'):
            tensors, host_extras = split_host_batch(batch)
            B = next(iter(tensors.values())).shape[0]
            with torch.inference_mode():
                if mesh is not None:
                    outputs = _mesh_forward(mesh, replicas, tensors, B, full,
                                            create_images)
                elif streaming:
                    if states is None:
                        if B != 1:
                            raise ValueError('streaming inference runs one '
                                             'clip a batch, got %d' % B)
                        states = eve_lib.init_stream_state(model.spec, B,
                                                           device)
                    outputs = model(_to(tensors, device),
                                    output_predictions=True,
                                    create_images=create_images,
                                    initial_states=states, return_states=True)
                    states = outputs.pop('states')
                else:
                    outputs = model(_to(tensors, device),
                                    output_predictions=True,
                                    create_images=create_images)
                with tracing.span('infer.d2h'):
                    outputs_np = {k: v.cpu().numpy()
                                  for k, v in outputs.items()}
            inputs_np = ({k: v.numpy() for k, v in tensors.items()}
                         if materialize_inputs else {})
            inputs_np.update(host_extras)
            if 'timestamps_ns' in host_extras:
                outputs_np['timestamps'] = host_extras['timestamps_ns']
        yield current_step, inputs_np, outputs_np


def _prefetched(model, dataloader, device, create_images):
    """``iterator``'s evaluation path over ``DevicePrefetcher``. The next
    batch is taken while the device runs this one, so the host's wait for
    it overlaps the forward; that wait is this batch's ``infer.h2d``."""
    staged = iter(DevicePrefetcher(dataloader, device))
    ahead = next(staged, None)
    current_step = 0
    while ahead is not None:
        with tracing.span('infer.batch'):
            tensors, host_extras = ahead
            with torch.inference_mode():
                outputs = model(tensors, output_predictions=True,
                                create_images=create_images)
                with tracing.span('infer.h2d'):
                    ahead = next(staged, None)
                with tracing.span('infer.d2h'):
                    outputs_np = {k: v.cpu().numpy()
                                  for k, v in outputs.items()}
            inputs_np = dict(host_extras)
            if 'timestamps_ns' in host_extras:
                outputs_np['timestamps'] = host_extras['timestamps_ns']
        yield current_step, inputs_np, outputs_np
        current_step += 1


def _to(tensors, device):
    with tracing.span('infer.h2d'):
        return {k: v.to(device) for k, v in tensors.items()}


def _mesh_forward(mesh, replicas, tensors, rows, full, create_images):
    """One batch over the mesh: pad to ``full`` rows with the last clip,
    launch every slice's forward, then join the outputs and cut the pad."""
    if rows < full:
        tensors = {k: torch.cat([v, v[-1:].expand(full - rows,
                                                  *v.shape[1:])])
                   for k, v in tensors.items()}
    with tracing.span('infer.h2d'):
        shards = mesh_lib.shard_batch(mesh, tensors)
    parts = [replica(part, output_predictions=True,
                     create_images=create_images)
             for replica, part in zip(replicas, shards)]
    out = mesh_lib.gather_rows(parts, full // mesh.size)
    return {k: v[:rows] if v.ndim >= 1 and v.shape[0] == full else v
            for k, v in out.items()}
