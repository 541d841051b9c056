"""Synthetic EVE clips with analytically known geometry: the benchmark's
frozen copy of the program's synthetic batch generator.

A virtual camera at a seeded rig transform, eyes at a seeded 3-D origin,
head rotations, and (with labels) ground-truth gazes derived from sampled
screen points, so that a perfect estimator projects back onto them. With
labels the eye patches carry a bright pupil disc whose offset encodes the
gaze; without them (a clip as a client or the reader hands it) eye patches
and screen frames are noise. Arrays are numpy, NHWC, as the program's
clients and data reader give them.

The small per-clip arrays are drawn from a ``numpy.random.RandomState``
in a fixed order; the frames of unlabelled clips, which are most of the
bytes, are drawn in one call on ``frame_generator`` (a ``torch.Generator``,
on the card in a run) and copied to the host.
"""

import numpy as np
import torch

GAZE_ENC_RANGE = 1.0
GAZE_ENC_AMPL = 0.25
GAZE_ENC_RADIUS = 0.09
SCREEN_MM = (530.0, 300.0)
# Where the camera sits in screen coordinates (mm from the top-left
# corner). The program's generator puts it at the corner; here it sits at
# the screen's centre, so that a random EyeNet's gazes, which stay near
# (0, 0), meet the screen and are not clamped at its corner.
CAMERA_MM = (265.0, 150.0)


def rng_for(seed, stream):
    """A ``RandomState`` for ``(seed, stream)``; any whole ``seed``."""
    return np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence([int(seed), int(stream)])))


def _rotation(pitchyaw):
    p, y = pitchyaw
    rx = np.array([[1, 0, 0],
                   [0, np.cos(p), np.sin(p)],
                   [0, -np.sin(p), np.cos(p)]])
    ry = np.array([[np.cos(y), 0, np.sin(y)],
                   [0, 1, 0],
                   [-np.sin(y), 0, np.cos(y)]])
    return (ry @ rx).astype(np.float32)


def combined_gaze(origin, pog_mm, head_R, cam_T):
    """Gaze (pitch, yaw), user perspective, from an origin to a PoG on the
    screen plane (mm), in the head's frame."""
    pog3 = np.concatenate([pog_mm, np.zeros_like(pog_mm[..., :1])], -1)
    pog3 = (np.einsum('...ij,...j->...i', cam_T[..., :3, :3], pog3)
            + cam_T[..., :3, 3])
    d = -np.einsum('...ij,...j->...i', head_R, pog3 - origin)
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-7)
    return np.stack([np.arcsin(d[..., 1]), np.arctan2(d[..., 0], d[..., 2])],
                    -1).astype(np.float32)


def render_gaze_patches(g_pitchyaw, size):
    """(..., 2) gazes -> (..., size, size, 3) uint8 patches with a bright
    disc at centre + (pitch, yaw) / GAZE_ENC_RANGE * GAZE_ENC_AMPL * size."""
    g = np.asarray(g_pitchyaw, np.float32)
    enc = np.clip(g / GAZE_ENC_RANGE, -1.0, 1.0) * GAZE_ENC_AMPL
    cy = (0.5 + enc[..., 0]) * size
    cx = (0.5 + enc[..., 1]) * size
    yy = np.arange(size, dtype=np.float32)[:, None]
    xx = np.arange(size, dtype=np.float32)[None, :]
    d2 = ((yy - cy[..., None, None]) ** 2 + (xx - cx[..., None, None]) ** 2)
    patch = np.where(d2 <= (GAZE_ENC_RADIUS * size) ** 2, 230, 30
                     ).astype(np.uint8)
    return np.repeat(patch[..., None], 3, axis=-1)


def _noise_frames(frame_generator, shape):
    t = torch.randint(0, 256, shape, dtype=torch.uint8,
                      generator=frame_generator,
                      device=frame_generator.device)
    return t.cpu().numpy()


def make_synthetic_batch(rng, batch_size, sequence_len, eyes_size,
                         screen_size=(128, 72), with_screen=True,
                         with_gt=True, fps=10.0, frame_generator=None):
    """A geometry-consistent (B, T, ...) clip batch of numpy arrays with
    uint8 frames. ``with_gt=False`` leaves out the labels and draws noise
    eye patches and (``with_screen``) screen frames of ``screen_size``
    (width, height) on ``frame_generator``; labelled clips carry no
    screen."""
    B, T = batch_size, sequence_len
    ppm = np.array([1920.0 / SCREEN_MM[0], 1080.0 / SCREEN_MM[1]],
                   np.float32)
    batch = {}
    cam_T = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    for b in range(B):
        cam_T[b, :, :3, :3] = _rotation(rng.uniform(-0.15, 0.15, 2))
        cam_T[b, :, :3, 3] = np.array([rng.uniform(-40, 40) - CAMERA_MM[0],
                                       rng.uniform(-20, 20) - CAMERA_MM[1],
                                       rng.uniform(-10, 10)], np.float32)
    batch['camera_transformation'] = cam_T
    batch['inv_camera_transformation'] = np.linalg.inv(cam_T).astype(
        np.float32)
    batch['millimeters_per_pixel'] = np.tile((1.0 / ppm).astype(np.float32),
                                             (B, T, 1))
    batch['pixels_per_millimeter'] = np.tile(ppm, (B, T, 1))

    o_mid = np.stack([rng.uniform(-30, 30, (B, T)),
                      rng.uniform(-20, 20, (B, T)),
                      rng.uniform(550, 650, (B, T))], -1).astype(np.float32)
    eye_gap = np.array([31.0, 0.0, 0.0], np.float32)
    batch['left_o'] = o_mid + eye_gap
    batch['right_o'] = o_mid - eye_gap
    head_R = np.zeros((B, T, 3, 3), np.float32)
    for b in range(B):
        head_R[b, :] = _rotation(rng.uniform(-0.2, 0.2, 2))
    batch['head_R'] = head_R
    batch['left_R'] = head_R.copy()
    batch['right_R'] = head_R.copy()
    batch['left_h'] = rng.uniform(-0.3, 0.3, (B, T, 2)).astype(np.float32)
    batch['right_h'] = rng.uniform(-0.3, 0.3, (B, T, 2)).astype(np.float32)
    batch['timestamps'] = ((np.arange(T) * (1e9 / fps) + 1.0)[None, :]
                           .repeat(B, 0).astype(np.float32))
    ones = np.ones((B, T), np.float32)
    for side in ('left', 'right'):
        batch[side + '_o_validity'] = ones.copy()
        batch[side + '_R_validity'] = ones.copy()

    if with_gt:
        pog_px = np.stack([rng.uniform(200, 1700, (B, T)),
                           rng.uniform(150, 950, (B, T))],
                          -1).astype(np.float32)
        for side in ('left', 'right'):
            g = combined_gaze(batch[side + '_o'], pog_px / ppm, head_R,
                              cam_T)
            batch[side + '_g_tobii'] = g
            batch[side + '_g_tobii_validity'] = ones.copy()
            batch[side + '_PoG_tobii'] = pog_px.copy()
            batch[side + '_PoG_tobii_validity'] = ones.copy()
            batch[side + '_p'] = rng.uniform(2, 5, (B, T)).astype(np.float32)
            batch[side + '_p_validity'] = ones.copy()
            batch[side + '_eye_patch'] = render_gaze_patches(g, eyes_size)
    else:
        eyes = (B, T, eyes_size, eyes_size, 3)
        for side in ('left', 'right'):
            batch[side + '_eye_patch'] = _noise_frames(frame_generator, eyes)
        if with_screen:
            batch['screen_frame'] = _noise_frames(
                frame_generator, (B, T, screen_size[1], screen_size[0], 3))
    return batch
