#!/usr/bin/env python3
"""Produce a Codalab submission archive from the EVE test split.

Usage:
    python -m eve_tpu_torch.cli.eval_codalab [config.json ...] \
        --datasrc-eve <eve root> --resume-from <run_dir> [--device cuda|cpu]

Writes ``for_codalab_<ts>.pkl.gz`` and its ``.zip`` into the run directory,
as ``eve_tpu/cli/eval_codalab.py`` does (the reference's
src/eval_codalab.py:45-104): per (participant, subfolder, camera), the
concatenated timestamps, pupil sizes and ``PoG_px_{initial,final}`` of its
clips, pickled with protocol 3. ``collect`` and ``write_submission`` are
the two halves, usable on any iterator of ``infer.iterator``'s form.
Reading the dataset needs ``h5py`` and ``ffmpeg`` or ``cv2``.

``--tpu-num-devices N`` (0, the default, is every visible card) evaluates
data-parallel in this process over the largest count up to N that divides
``codalab_eval_batch_size`` (``_eval_mesh``); the submission is the one
device's.
"""

import gzip
import logging
import os
import pickle
import time
import zipfile

import numpy as np
import torch

from eve_tpu_torch import infer
from eve_tpu_torch.cli import common
from eve_tpu_torch.data.dataset import EVESequences_test
from eve_tpu_torch.data.loader import DataLoader
from eve_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)

KEYS_TO_STORE = ['timestamps', 'left_pupil_size', 'right_pupil_size',
                 'PoG_px_initial', 'PoG_px_final']


def script_init_common(argv=None):
    return common.parse_config(
        argv, 'Codalab evaluation for EVE.', defaults={
            'fully_reproducible': True, 'refine_net_enabled': True,
            'load_screen_content': True,
            'load_full_frame_for_visualization': False})


def init_dataset(config):
    dataset = EVESequences_test(config.datasrc_eve, config=config,
                                is_final_test=True)
    dataloader = DataLoader(dataset,
                            batch_size=config.codalab_eval_batch_size,
                            shuffle=False, drop_last=False,
                            num_workers=config.codalab_eval_data_workers)
    return dataset, dataloader


def _eval_mesh(config, batch_size, device='cuda'):
    """The data-parallel eval mesh (``--tpu-num-devices``, 0 = all), or
    None for one device.

    eve_tpu's rule: the largest device count that divides the batch, so
    every device takes an equal share of the clips, with a warning when
    that is fewer than the available devices. On the card the devices are
    ``cuda:0..n-1``; on another device type (the CPU) n replicas of it.
    """
    device = torch.device(device)
    visible = torch.cuda.device_count() if device.type == 'cuda' else 1
    n_use = mesh_lib.data_axis_size(
        batch_size, config.tpu_num_devices or visible,
        'codalab_eval_batch_size')
    if n_use <= 1:
        return None
    logger.info('evaluating data-parallel over %d devices', n_use)
    if device.type == 'cuda':
        return mesh_lib.make_mesh(n_use)
    return mesh_lib.make_mesh(devices=[device] * n_use)


def collect(batches):
    """``{participant: {subfolder: {camera: {key: array}}}}`` from the
    ``(step, inputs, outputs)`` of ``infer.iterator``: each sequence's clips
    concatenated along time, in the order they come."""
    outputs_to_write = {}
    processed_so_far = set()
    for _, inputs, outputs in batches:
        for i in range(outputs['PoG_px_initial'].shape[0]):
            sequence_key = (inputs['participant'][i], inputs['subfolder'][i],
                            inputs['camera'][i])
            participant, subfolder, camera = sequence_key
            sub_dict = outputs_to_write.setdefault(
                participant, {}).setdefault(subfolder, {})
            if camera in sub_dict:
                for key in KEYS_TO_STORE:
                    sub_dict[camera][key] = np.concatenate(
                        [sub_dict[camera][key], outputs[key][i]], axis=0)
            else:
                sub_dict[camera] = {key: outputs[key][i]
                                    for key in KEYS_TO_STORE}
            if sequence_key not in processed_so_far:
                print('Handling %s/%s/%s' % sequence_key)
                processed_so_far.add(sequence_key)
    return outputs_to_write


def write_submission(outputs_to_write, out_dir):
    """Write ``for_codalab_<ts>.pkl.gz`` and a ``.zip`` holding it into
    ``out_dir``; returns ``(pkl_gz_path, zip_path)``."""
    output_fname = 'for_codalab_%s.pkl.gz' % time.strftime('%y%m%d_%H%M%S')
    final_output_path = os.path.join(out_dir, output_fname)
    with gzip.open(final_output_path, 'wb') as f:
        pickle.dump(outputs_to_write, f, protocol=3)
    zip_output_path = final_output_path[:-len('.pkl.gz')] + '.zip'
    with zipfile.ZipFile(zip_output_path, 'w') as zf:
        zf.write(final_output_path, arcname=output_fname)
    return final_output_path, zip_output_path


def main(argv=None):
    config, args = script_init_common(argv)
    if not config.resume_from:
        raise ValueError('--resume-from is required')
    # float32 results: cuDNN would run float32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, dataloader = init_dataset(config)
    model = infer.model_setup(config, device=args.device)
    mesh = _eval_mesh(config, config.codalab_eval_batch_size, args.device)
    # Only the host-side strings are read from the inputs.
    outputs_to_write = collect(infer.iterator(
        model, dataloader, create_images=False, materialize_inputs=False,
        mesh=mesh))
    _, zip_path = write_submission(outputs_to_write, config.resume_from)
    print('> Wrote %s' % zip_path)
    return zip_path


if __name__ == '__main__':
    main()
