"""Synthetic EVE-like batches with analytically known geometry.

A numpy/torch copy of ``make_synthetic_batch`` from
``eve_tpu/data/synthetic.py`` ('disc' appearance only), using the port's
geometry: a virtual camera at a known rig transform, eyes at a known 3D
origin, and ground-truth gazes derived from sampled screen points, so a
perfect estimator projects back onto them. Given the same
``np.random.RandomState`` the two packages build the same batch.
"""

import numpy as np
import torch

from eve_tpu_torch.ops import geometry as geo

# Pupil-disc gaze encoding: the disc centre's offset from the patch centre is
# linear in the gaze pitch/yaw.
GAZE_ENC_RANGE = 1.0
GAZE_ENC_AMPL = 0.25
GAZE_ENC_RADIUS = 0.09


def _rotation_np(pitchyaw):
    p, y = pitchyaw
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(p), np.sin(p)],
                   [0, -np.sin(p), np.cos(p)]])
    Ry = np.array([[np.cos(y), 0, np.sin(y)],
                   [0, 1, 0],
                   [-np.sin(y), 0, np.cos(y)]])
    return (Ry @ Rx).astype(np.float32)


def render_gaze_patches(g_pitchyaw, size):
    """(..., 2) gazes -> (..., size, size, 3) uint8 patches with a bright disc
    at centre + (pitch, yaw) / GAZE_ENC_RANGE * GAZE_ENC_AMPL * size."""
    g = np.asarray(g_pitchyaw, np.float32)
    lead = g.shape[:-1]
    enc = np.clip(g / GAZE_ENC_RANGE, -1.0, 1.0) * GAZE_ENC_AMPL
    cy = (0.5 + enc[..., 0]) * size
    cx = (0.5 + enc[..., 1]) * size
    yy = np.arange(size, dtype=np.float32)[:, None]
    xx = np.arange(size, dtype=np.float32)[None, :]
    d2 = ((yy - cy[..., None, None]) ** 2 +
          (xx - cx[..., None, None]) ** 2)
    disc = d2 <= (GAZE_ENC_RADIUS * size) ** 2
    patch = np.full(lead + (size, size), 30, np.uint8)
    patch[disc] = 230
    return np.repeat(patch[..., None], 3, axis=-1)


def make_synthetic_batch(rng, batch_size=2, sequence_len=4, eyes_size=64,
                         screen_size=(128, 72), with_screen=True,
                         with_gt=True, frame_dtype=np.float32):
    """Build a geometry-consistent (B, T, ...) batch (numpy, NHWC).

    Frames at 30 fps; ``screen_size`` is (width, height) of the screen
    frames, which ``with_screen=False`` leaves out. ``with_gt=False`` leaves
    out the labels (a batch as a client sends it), and the eye patches are
    then noise. ``frame_dtype=np.uint8`` emits raw camera and screen bytes.
    """
    B, T = batch_size, sequence_len
    mm_w, mm_h = 530.0, 300.0  # physical screen size (mm)
    ppm = np.array([1920.0 / mm_w, 1080.0 / mm_h], np.float32)

    batch = {}
    screen_shape = (B, T, screen_size[1], screen_size[0], 3)
    if with_screen and frame_dtype == np.uint8:
        batch['screen_frame'] = rng.randint(0, 256, screen_shape).astype(
            np.uint8)
    elif with_screen:
        batch['screen_frame'] = rng.uniform(0, 1, screen_shape).astype(
            np.float32)

    cam_T = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    for b in range(B):
        R = _rotation_np(rng.uniform(-0.15, 0.15, 2))
        t = np.array([rng.uniform(-40, 40), rng.uniform(-20, 20),
                      rng.uniform(-10, 10)], np.float32)
        cam_T[b, :, :3, :3] = R
        cam_T[b, :, :3, 3] = t
    batch['camera_transformation'] = cam_T
    batch['inv_camera_transformation'] = np.linalg.inv(cam_T).astype(np.float32)
    batch['millimeters_per_pixel'] = np.tile(
        (1.0 / ppm).astype(np.float32), (B, T, 1))
    batch['pixels_per_millimeter'] = np.tile(ppm, (B, T, 1))

    o_mid = np.stack([rng.uniform(-30, 30, (B, T)),
                      rng.uniform(-20, 20, (B, T)),
                      rng.uniform(550, 650, (B, T))], -1).astype(np.float32)
    eye_gap = np.array([31.0, 0.0, 0.0], np.float32)
    batch['left_o'] = o_mid + eye_gap
    batch['right_o'] = o_mid - eye_gap

    head_R = np.zeros((B, T, 3, 3), np.float32)
    for b in range(B):
        head_R[b, :] = _rotation_np(rng.uniform(-0.2, 0.2, 2))
    batch['head_R'] = head_R
    batch['left_R'] = head_R.copy()
    batch['right_R'] = head_R.copy()
    batch['left_h'] = rng.uniform(-0.3, 0.3, (B, T, 2)).astype(np.float32)
    batch['right_h'] = rng.uniform(-0.3, 0.3, (B, T, 2)).astype(np.float32)

    step_ns = 1e9 / 30.0
    ts = (np.arange(T) * step_ns + 1.0)[None, :].repeat(B, 0)
    batch['timestamps'] = ts.astype(np.float32)

    ones = np.ones((B, T), np.float32)
    for side in ('left', 'right'):
        batch[side + '_o_validity'] = ones.copy()
        batch[side + '_R_validity'] = ones.copy()

    if with_gt:
        PoG_px = np.stack([rng.uniform(200, 1700, (B, T)),
                           rng.uniform(150, 950, (B, T))],
                          -1).astype(np.float32)
        PoG_mm = PoG_px / ppm
        for side in ('left', 'right'):
            with torch.no_grad():
                g = geo.calculate_combined_gaze_direction(
                    torch.from_numpy(batch[side + '_o']),
                    torch.from_numpy(PoG_mm), torch.from_numpy(head_R),
                    torch.from_numpy(cam_T))
            batch[side + '_g_tobii'] = g.numpy()
            batch[side + '_g_tobii_validity'] = ones.copy()
            batch[side + '_PoG_tobii'] = PoG_px.copy()
            batch[side + '_PoG_tobii_validity'] = ones.copy()
            batch[side + '_p'] = rng.uniform(2, 5, (B, T)).astype(np.float32)
            batch[side + '_p_validity'] = ones.copy()

    for side in ('left', 'right'):
        if with_gt:
            patch = render_gaze_patches(batch[side + '_g_tobii'], eyes_size)
        else:
            patch = rng.randint(0, 256, (B, T, eyes_size, eyes_size, 3)
                                ).astype(np.uint8)
        if frame_dtype == np.uint8:
            batch[side + '_eye_patch'] = patch
        else:
            batch[side + '_eye_patch'] = (
                patch.astype(np.float32) * (2.0 / 255.0) - 1.0)
    return batch
