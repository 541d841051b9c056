#!/usr/bin/env python3
"""Run EVE inference on one video and write a PoG-overlay mp4.

Usage:
    python -m eve_tpu_torch.cli.inference [config.json ...] \
        --input-path <eve>/val01/step008_image_xyz/webcam_c.mp4 \
        --output-path out.mp4 [--resume-from <run_dir>] [--device cuda|cpu]

The loop of ``eve_tpu/cli/inference.py``: the video's clips go through
``infer.iterator`` with ``create_images`` (``--inference-streaming yes``
carries the recurrent state from clip to clip), and every frame of the
screen recording gets the initial, refined and ground-truth PoG drawn on
it. Without ``--resume-from`` the released weights are used where
``$EVE_PRETRAINED_DIR`` holds them. Reading the dataset needs ``h5py`` and
``ffmpeg`` or ``cv2``; drawing needs ``cv2``.
"""

import logging
import os

import numpy as np
import torch

from eve_tpu_torch import infer
from eve_tpu_torch.utils.visualization import (
    COLOR_FINAL, COLOR_GT, COLOR_INITIAL, VideoEncoder, draw_pog_overlay)

logger = logging.getLogger(__name__)


def _screens(inputs):
    """(B, T, H, W, 3) uint8 RGB canvases: the full screen recording when
    loaded, else the screen content upscaled to 1920x1080."""
    if 'screen_full_frame' in inputs:
        return inputs['screen_full_frame']
    import cv2
    sf = np.asarray(inputs['screen_frame'])
    if sf.dtype != np.uint8:
        sf = (sf * 255).astype(np.uint8)
    return np.stack([np.stack([cv2.resize(f, (1920, 1080)) for f in clip])
                     for clip in sf])


def _eye_strips(inputs):
    """(B, T, H, 2W, 3) uint8 [right | left] eye strips, or None."""
    if 'left_eye_patch' not in inputs:
        return None
    strip = np.concatenate([np.asarray(inputs['right_eye_patch']),
                            np.asarray(inputs['left_eye_patch'])], axis=3)
    if strip.dtype == np.uint8:
        return strip
    return ((strip + 1.0) * (255.0 / 2.0)).astype(np.uint8)


def draw_batch(inputs, outputs, actual_screen_size):
    """Yield the overlay frame (BGR uint8) of every frame of a batch."""
    all_PoG_init = outputs['PoG_px_initial']
    all_PoG_final = outputs.get('PoG_px_final')
    all_PoG_gt = outputs.get('PoG_px_gt')
    all_gt_validity = outputs.get('PoG_px_gt_validity')
    have_gt = 'left_g_gt' in outputs and all_PoG_gt is not None
    num_entries, sequence_len = all_PoG_init.shape[:2]

    screens = _screens(inputs)
    # PoGs are in actual_screen_size px; scale them to the canvas, which is
    # smaller than 1920x1080 only for a stand-in recording.
    canvas_h, canvas_w = screens.shape[2:4]
    aw, ah = actual_screen_size
    pog_scale = np.array([canvas_w / aw, canvas_h / ah], np.float32)
    all_PoG_init = np.asarray(all_PoG_init) * pog_scale
    if all_PoG_final is not None:
        all_PoG_final = np.asarray(all_PoG_final) * pog_scale
    if all_PoG_gt is not None:
        all_PoG_gt = np.asarray(all_PoG_gt) * pog_scale
    eyes = _eye_strips(inputs)

    for index in range(num_entries):
        valid = np.ones(sequence_len, bool)
        to_draw = [('Initial Estimate', all_PoG_init[index], valid,
                    COLOR_INITIAL)]
        if all_PoG_final is not None:
            to_draw.append(('After Refinement (Ours)', all_PoG_final[index],
                            valid, COLOR_FINAL))
        gt = gt_validity = None
        if have_gt:
            gt = all_PoG_gt[index]
            gt_validity = all_gt_validity[index].astype(bool)
            to_draw.append(('Tobii Data (Groundtruth)', gt, gt_validity,
                            COLOR_GT))
        for t in range(sequence_len):
            frame = np.ascontiguousarray(screens[index, t][:, :, ::-1])
            draw_pog_overlay(
                frame, to_draw,
                eyes_bgr=(eyes[index, t][:, :, ::-1]
                          if eyes is not None else None),
                draw_gt_lines=have_gt, gt=gt, gt_validity=gt_validity,
                t=t, ui_scale=canvas_w / aw)
            yield frame


def main(argv=None):
    config, args = infer.script_init_common(argv)
    # float32 results: cuDNN would run float32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, dataloader = infer.init_dataset(config)
    model = infer.model_setup(config, device=args.device)

    output_dir = os.path.dirname(config.output_path)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    encoder = VideoEncoder(config.output_path, fps=config.assumed_frame_rate)
    try:
        for _, inputs, outputs in infer.iterator(
                model, dataloader, streaming=config.inference_streaming):
            for frame in draw_batch(inputs, outputs,
                                    config.actual_screen_size):
                encoder.write(frame)
    finally:
        encoder.close()
    print('> Wrote %s' % config.output_path)


if __name__ == '__main__':
    main()
