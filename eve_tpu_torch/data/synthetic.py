"""Synthetic EVE-like data with analytically known geometry.

A numpy/torch copy of ``eve_tpu/data/synthetic.py``, using the port's
geometry: a virtual camera at a known rig transform, eyes at a known 3D
origin, and ground-truth gazes derived from sampled screen points, so a
perfect estimator projects back onto them.

- ``make_synthetic_batch``: a (B, T, ...) batch, with eye patches of the
  'disc' appearance (a bright pupil disc whose offset encodes the gaze;
  ``decode_gaze_from_patch`` inverts it) or the 'adversarial' one
  (``render_gaze_patches_adversarial``: an eye-like patch whose iris
  carries the same encoding, hostile to naive decoding; its randomness
  lives in per-frame latents, so ``oracle_decode_gaze`` can re-render
  candidate gazes and pick the nearest).
- ``write_synthetic_dataset``: an on-disk tree in the EVE layout (per
  camera ``<cam>_eyes.mp4``, ``<cam>.h5`` labels and
  ``<cam>.timestamps.txt``, plus the screen videos), the dataset the
  port's reader and CLIs take. It needs ``h5py`` and ``cv2``, imported
  inside it.

Given the same ``np.random.RandomState`` (or seed) the two packages draw
in the same order and build the same data.
"""

import os

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


def decode_gaze_from_patch(patch_uint8):
    """Inverse of ``render_gaze_patches``: (pitch, yaw) in radians from the
    centroid of the bright pixels, below the frame-index band that
    ``write_synthetic_dataset`` draws in the top rows."""
    p = np.asarray(patch_uint8, np.float32).mean(-1)
    size = p.shape[-1]
    mask = (p > 128).astype(np.float32)
    mask[..., :int(0.15 * size), :] = 0.0
    yy = np.arange(size, dtype=np.float32)[:, None]
    xx = np.arange(size, dtype=np.float32)[None, :]
    total = np.maximum(mask.sum((-2, -1)), 1e-6)
    cy = (mask * yy).sum((-2, -1)) / total
    cx = (mask * xx).sum((-2, -1)) / total
    pitch = (cy / size - 0.5) / GAZE_ENC_AMPL * GAZE_ENC_RANGE
    yaw = (cx / size - 0.5) / GAZE_ENC_AMPL * GAZE_ENC_RANGE
    return np.stack([pitch, yaw], -1)


def _combined_gaze(origin, PoG_mm, head_R, cam_T):
    """The port's ``calculate_combined_gaze_direction`` on numpy arrays."""
    with torch.no_grad():
        g = geo.calculate_combined_gaze_direction(
            torch.from_numpy(origin), torch.from_numpy(PoG_mm),
            torch.from_numpy(head_R), torch.from_numpy(cam_T))
    return g.numpy()


def make_synthetic_batch(rng, batch_size=2, sequence_len=4, eyes_size=64,
                         screen_size=(128, 72), with_screen=True,
                         with_gt=True, fps=30.0, frame_dtype=np.float32,
                         appearance='disc'):
    """Build a geometry-consistent (B, T, ...) batch (numpy, NHWC).

    Frames at ``fps``; ``screen_size`` is (width, height) of the screen
    frames, which ``with_screen=False`` leaves out. ``with_gt=False`` leaves
    out the labels (a batch as a client sends it), and the eye patches are
    then noise. ``frame_dtype=np.uint8`` emits raw camera and screen bytes.
    ``appearance``: 'disc' or 'adversarial' eye patches (module docstring).
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

    step_ns = 1e9 / fps
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
            batch[side + '_g_tobii'] = _combined_gaze(
                batch[side + '_o'], PoG_mm, head_R, cam_T)
            batch[side + '_g_tobii_validity'] = ones.copy()
            batch[side + '_PoG_tobii'] = PoG_px.copy()
            batch[side + '_PoG_tobii_validity'] = ones.copy()
            batch[side + '_p'] = rng.uniform(2, 5, (B, T)).astype(np.float32)
            batch[side + '_p_validity'] = ones.copy()

    for side in ('left', 'right'):
        if with_gt and appearance == 'adversarial':
            lat = sample_appearance_latents(rng, (B, T))
            patch = render_gaze_patches_adversarial(
                batch[side + '_g_tobii'], eyes_size, lat)
        elif with_gt:
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


# ----------------------------------------------------------------------
# The adversarial appearance
# ----------------------------------------------------------------------
#
# The disc encoding is trivially decodable (a thresholded bright centroid
# inverts it to ~1 px). This renderer keeps the same analytic label path
# (the IRIS centre's offset from the patch centre is the same linear
# encoding of gaze), but the appearance is eye-like and hostile to naive
# decoding: a bright textured sclera with a DARK iris and pupil, a shaded
# pupil and a striated iris with a dark rim, eyelids with lashes, 1-2
# specular glints offset from the iris (the brightest pixels), bright and
# dark distractor blobs, and per-frame exposure, gamma, blur, noise and
# channel tints. All its randomness lives in gaze-independent per-frame
# latents (``sample_appearance_latents``), so a patch is a deterministic
# function of (gaze, latents), which ``oracle_decode_gaze`` inverts by
# re-rendering candidate gazes.

_ADV_UNIFORM = {
    'sclera_base': (150.0, 205.0), 'sclera_amp': (4.0, 12.0),
    'sclera_fx': (1.0, 3.0), 'sclera_fy': (1.0, 3.0),
    'sclera_px': (0.0, 6.283), 'sclera_py': (0.0, 6.283),
    'skin_base': (110.0, 175.0), 'skin_amp': (5.0, 15.0),
    'skin_f': (2.0, 5.0), 'skin_p': (0.0, 6.283),
    'lid_top_edge': (0.16, 0.30), 'lid_top_arch': (0.04, 0.14),
    'lid_bot_edge': (0.74, 0.88), 'lid_bot_arch': (0.03, 0.10),
    'lash_dark': (15.0, 55.0), 'lash_thick': (0.015, 0.035),
    'iris_rho': (0.14, 0.20), 'iris_base': (70.0, 130.0),
    'iris_stria_amp': (12.0, 28.0), 'iris_stria_k': (6.0, 14.0),
    'iris_stria_phase': (0.0, 6.283), 'iris_rim_drop': (20.0, 45.0),
    'pupil_ratio': (0.35, 0.55), 'pupil_base': (8.0, 35.0),
    'pupil_slope': (10.0, 30.0),
    'glint_r': (0.20, 0.62), 'glint_ang': (0.0, 6.283),
    'glint_sigma': (0.015, 0.035),
    'glint2_r': (0.20, 0.62), 'glint2_ang': (0.0, 6.283),
    'glint2_sigma': (0.012, 0.030),
    'iris_cr': (0.75, 1.15), 'iris_cg': (0.75, 1.15),
    'iris_cb': (0.75, 1.20),
    'skin_cr': (1.00, 1.15), 'skin_cg': (0.85, 1.00),
    'skin_cb': (0.70, 0.90),
    'exposure': (0.70, 1.15), 'gamma': (0.80, 1.25),
    'noise_sigma': (1.5, 7.0),
}


def sample_appearance_latents(rng, lead_shape):
    """Per-frame appearance latents for the adversarial renderer.

    Every entry is gaze-INDEPENDENT (shape ``lead_shape`` or
    ``lead_shape + (k,)``), so a patch is a deterministic function of
    (gaze, latents) and candidate gazes can be re-rendered against the
    same latents (the oracle-decoder construction).
    """
    lat = {k: rng.uniform(lo, hi, lead_shape).astype(np.float32)
           for k, (lo, hi) in _ADV_UNIFORM.items()}
    lat['glint2_on'] = (rng.uniform(0, 1, lead_shape) < 0.6
                        ).astype(np.float32)
    # Up to 3 bright + 2 dark distractor blobs, normalized positions.
    lat['db_on'] = (rng.uniform(0, 1, lead_shape + (3,)) <
                    np.float32([0.8, 0.5, 0.3])).astype(np.float32)
    lat['db_y'] = rng.uniform(0.05, 0.95, lead_shape + (3,)
                              ).astype(np.float32)
    lat['db_x'] = rng.uniform(0.05, 0.95, lead_shape + (3,)
                              ).astype(np.float32)
    lat['db_sigma'] = rng.uniform(0.02, 0.05, lead_shape + (3,)
                                  ).astype(np.float32)
    lat['db_amp'] = rng.uniform(170.0, 245.0, lead_shape + (3,)
                                ).astype(np.float32)
    lat['dd_on'] = (rng.uniform(0, 1, lead_shape + (2,)) <
                    np.float32([0.7, 0.4])).astype(np.float32)
    lat['dd_y'] = rng.uniform(0.05, 0.95, lead_shape + (2,)
                              ).astype(np.float32)
    lat['dd_x'] = rng.uniform(0.05, 0.95, lead_shape + (2,)
                              ).astype(np.float32)
    lat['dd_sigma'] = rng.uniform(0.02, 0.06, lead_shape + (2,)
                                  ).astype(np.float32)
    lat['dd_val'] = rng.uniform(12.0, 55.0, lead_shape + (2,)
                                ).astype(np.float32)
    lat['blur_n'] = np.floor(rng.uniform(0.0, 3.0, lead_shape)
                             ).astype(np.float32)  # 0..2 box-blur passes
    lat['noise_seed'] = rng.uniform(0.0, 1000.0, lead_shape
                                    ).astype(np.float32)
    return lat


def _smoothstep(edge0, edge1, x):
    t = np.clip((x - edge0) / (edge1 - edge0 + 1e-9), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _hash_noise(yy, xx, seed):
    """Deterministic shader-style pseudo-noise in [-1, 1], vectorized."""
    v = np.sin(yy * 12.9898 + xx * 78.233 + seed * 37.719) * 43758.5453
    return (v - np.floor(v)) * 2.0 - 1.0


def _box_blur(img):
    """One 3x3 box-blur pass over the last two axes (edge-replicated)."""
    p = np.pad(img, [(0, 0)] * (img.ndim - 2) + [(1, 1), (1, 1)],
               mode='edge')
    out = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] +
           p[..., 1:-1, 2:] + 4.0 * p[..., 1:-1, 1:-1]) / 8.0
    return out


def render_gaze_patches_adversarial(g_pitchyaw, size, latents):
    """Adversarial-appearance eye patches; same gaze encoding as the disc.

    Args:
      g_pitchyaw: (..., 2) gaze (pitch, yaw) radians.
      size: patch height/width in pixels.
      latents: :func:`sample_appearance_latents` output with matching
        leading shape.

    Returns:
      (..., size, size, 3) uint8 patches.
    """
    g = np.asarray(g_pitchyaw, np.float32)
    lead = g.shape[:-1]
    N = int(np.prod(lead)) if lead else 1
    S = int(size)
    g2 = g.reshape(N, 2)
    lat = {k: np.asarray(v, np.float32).reshape((N,) + v.shape[len(lead):])
           for k, v in latents.items()}

    def L(key):  # (N, 1, 1) broadcastable scalar latent
        return lat[key][:, None, None]

    enc = np.clip(g2 / GAZE_ENC_RANGE, -1.0, 1.0) * GAZE_ENC_AMPL
    cy = ((0.5 + enc[:, 0]) * S)[:, None, None]
    cx = ((0.5 + enc[:, 1]) * S)[:, None, None]
    yy = np.arange(S, dtype=np.float32)[None, :, None]
    xx = np.arange(S, dtype=np.float32)[None, None, :]

    # Sclera: bright, low-frequency texture, corner vignette.
    lum = (L('sclera_base') +
           L('sclera_amp') *
           np.sin(2 * np.pi * L('sclera_fx') * xx / S + L('sclera_px')) *
           np.sin(2 * np.pi * L('sclera_fy') * yy / S + L('sclera_py')) -
           50.0 * (((yy - S / 2) ** 2 + (xx - S / 2) ** 2) /
                   (2 * (S / 2) ** 2)))

    # Iris + pupil, centered at the gaze encoding.
    dy, dx = yy - cy, xx - cx
    d = np.sqrt(dy * dy + dx * dx)
    theta = np.arctan2(dy, dx)
    r_i = L('iris_rho') * S
    r_p = L('pupil_ratio') * r_i
    stria_w = _smoothstep(r_p, r_p + 2.0, d) * (1 - _smoothstep(
        0.85 * r_i, r_i, d))
    iris_lum = (L('iris_base') +
                L('iris_stria_amp') *
                np.sin(np.round(lat['iris_stria_k'])[:, None, None] * theta +
                       L('iris_stria_phase')) * stria_w -
                L('iris_rim_drop') * _smoothstep(0.70 * r_i, r_i, d))
    pupil_lum = L('pupil_base') + L('pupil_slope') * (
        d / np.maximum(r_p, 1.0))
    iris_mask = 1 - _smoothstep(r_i - 1.5, r_i + 1.5, d)
    pupil_mask = 1 - _smoothstep(r_p - 1.0, r_p + 1.0, d)
    lum = lum + (iris_lum - lum) * iris_mask
    lum = lum + (pupil_lum - lum) * pupil_mask

    # Specular glints on the eyeball: the brightest pixels, OFFSET from
    # the iris center (bright-centroid decoders lock onto these).
    for pre, on in (('glint', None), ('glint2', lat['glint2_on'])):
        gy = cy + lat[pre + '_r'][:, None, None] * r_i * np.sin(
            lat[pre + '_ang'])[:, None, None]
        gx = cx + lat[pre + '_r'][:, None, None] * r_i * np.cos(
            lat[pre + '_ang'])[:, None, None]
        sg = lat[pre + '_sigma'][:, None, None] * S
        blob = np.exp(-((yy - gy) ** 2 + (xx - gx) ** 2) / (2 * sg * sg))
        if on is not None:
            blob = blob * on[:, None, None]
        lum = lum + (252.0 - lum) * blob

    # Eyelids (skin overlays the eyeball, occluding iris top/bottom), with
    # the pupil center kept visible so the task stays learnable.
    ux = S * (L('lid_top_edge') - L('lid_top_arch') *
              np.sin(np.pi * xx / S))
    ux = np.minimum(ux, cy - 0.08 * S)
    lx = S * (L('lid_bot_edge') + L('lid_bot_arch') *
              np.sin(np.pi * xx / S))
    lx = np.maximum(lx, cy + 0.08 * S)
    skin_top = 1 - _smoothstep(ux - 1.0, ux + 1.0, yy)
    skin_bot = _smoothstep(lx - 1.0, lx + 1.0, yy)
    skin_w = np.clip(skin_top + skin_bot, 0.0, 1.0)
    skin_lum = L('skin_base') + L('skin_amp') * np.sin(
        2 * np.pi * L('skin_f') * (xx + yy) / (2 * S) + L('skin_p'))
    lum = lum + (skin_lum - lum) * skin_w

    # Eyelash strokes: a dark modulated band along the upper lid (defeats
    # dark-centroid decoding; the pupil is no longer uniquely dark).
    lash_band = np.exp(-((yy - ux) / (L('lash_thick') * S + 0.5)) ** 2)
    strokes = 0.55 + 0.45 * np.sin(xx * (40.0 / S) * 2 * np.pi +
                                   L('skin_p'))
    lash_mask = np.clip(lash_band * strokes, 0.0, 1.0)
    lum = lum + (L('lash_dark') - lum) * lash_mask

    # Distractor blobs (bright and dark), suppressed near the iris.
    far = _smoothstep(1.25 * r_i, 1.6 * r_i, d)
    for j in range(lat['db_on'].shape[1]):
        by = lat['db_y'][:, j][:, None, None] * S
        bx = lat['db_x'][:, j][:, None, None] * S
        sg = lat['db_sigma'][:, j][:, None, None] * S
        blob = (np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * sg * sg))
                * lat['db_on'][:, j][:, None, None] * far)
        lum = lum + (lat['db_amp'][:, j][:, None, None] - lum) * blob
    for j in range(lat['dd_on'].shape[1]):
        by = lat['dd_y'][:, j][:, None, None] * S
        bx = lat['dd_x'][:, j][:, None, None] * S
        sg = lat['dd_sigma'][:, j][:, None, None] * S
        blob = (np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * sg * sg))
                * lat['dd_on'][:, j][:, None, None] * far)
        lum = lum + (lat['dd_val'][:, j][:, None, None] - lum) * blob

    # Per-region channel tints -> 3 channels.
    iris_only = np.clip(iris_mask - pupil_mask, 0.0, 1.0) * (1 - skin_w)
    img = np.empty((N, S, S, 3), np.float32)
    for c, (ic, sc) in enumerate((('iris_cr', 'skin_cr'),
                                  ('iris_cg', 'skin_cg'),
                                  ('iris_cb', 'skin_cb'))):
        gain = (1.0 + iris_only * (L(ic) - 1.0) +
                skin_w * (L(sc) - 1.0))
        img[..., c] = lum * gain

    # Per-frame exposure gain + gamma.
    img = 255.0 * np.clip(img * L('exposure')[..., None] / 255.0,
                          0.0, 1.0) ** L('gamma')[..., None]

    # 0..2 box-blur passes, selected per frame.
    b1 = _box_blur(img)
    b2 = _box_blur(b1)
    n_blur = lat['blur_n'][:, None, None, None]
    img = np.where(n_blur < 0.5, img, np.where(n_blur < 1.5, b1, b2))

    # Sensor noise (deterministic given the latent seed).
    noise = _hash_noise(yy[..., None], xx[..., None],
                        L('noise_seed')[..., None])
    img = img + noise * lat['noise_sigma'][:, None, None, None]

    out = np.clip(img, 0.0, 255.0).astype(np.uint8)
    return out.reshape(lead + (S, S, 3))


def oracle_decode_gaze(patch_uint8, latents, size=None, span=1.0,
                       levels=3, grid=9):
    """Recover gaze from adversarial patches by re-render matching.

    Coarse-to-fine template search: render candidate gazes with the SAME
    latents, pick the L2-nearest, refine around it. Proves the encoding
    is invertible-in-principle (and codec-robust) even though threshold-
    centroid decoding fails — this decoder needs the full generative
    model, which is exactly the point.

    Args:
      patch_uint8: (..., S, S, 3) patches.
      latents: the latents the patches were rendered with.
      span: half-width (radians) of the initial search square.
    Returns: (..., 2) estimated (pitch, yaw).
    """
    p = np.asarray(patch_uint8, np.float32)
    S = int(size or p.shape[-2])
    lead = p.shape[:-3]
    N = int(np.prod(lead)) if lead else 1
    obs = p.reshape(N, S, S, 3)
    lat = {k: np.asarray(v).reshape((N,) + v.shape[len(lead):])
           for k, v in latents.items()}
    center = np.zeros((N, 2), np.float32)
    half = float(span)
    for _ in range(levels):
        offs = np.linspace(-half, half, grid, dtype=np.float32)
        best_err = np.full(N, np.inf, np.float32)
        best = center.copy()
        for oy in offs:
            for ox in offs:
                cand = center + np.float32([oy, ox])
                rend = render_gaze_patches_adversarial(
                    cand, S, lat).astype(np.float32)
                err = ((rend - obs) ** 2).mean(axis=(1, 2, 3))
                take = err < best_err
                best_err = np.where(take, err, best_err)
                best = np.where(take[:, None], cand, best)
        center = best
        half = half * 2.0 / (grid - 1)  # next level spans +-1 coarse cell
    return center.reshape(lead + (2,))


# ----------------------------------------------------------------------
# On-disk synthetic dataset (EVE directory layout)
# ----------------------------------------------------------------------

def _write_video(path, frames_uint8, fps):
    """Write uint8 RGB frames to an mp4 via OpenCV."""
    import cv2
    h, w = frames_uint8.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'),
                             fps, (w, h))
    assert writer.isOpened(), path
    for frame in frames_uint8:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def write_synthetic_dataset(root, participants=('train01',),
                            stimuli=('step008_image_test',),
                            cameras=('webcam_c',), num_frames=40,
                            eyes_size=128, seed=0, appearance='disc'):
    """Write an EVE-layout dataset tree with analytic geometry labels.

    Per participant/stimulus: camera ``<cam>_eyes.mp4`` (2*eyes x eyes strip,
    30 fps), ``<cam>.h5`` labels, ``<cam>.timestamps.txt``; plus
    ``screen.128x72.mp4`` + ``screen.timestamps.txt``. Eye patches render the
    GT gaze (``appearance='disc'``: pupil disc, trivially decodable;
    ``'adversarial'``: eye-like appearance hostile to naive decoding —
    the accuracy-study fixture), making the pixels->gaze path genuinely
    learnable; a top band (and, in the screen/ full-frame videos, every
    pixel) encodes the frame index (5 + 6*index) so frame-exact decode
    stays verifiable through the lossy codec.
    """
    import h5py
    rng = np.random.RandomState(seed)
    fps = 30
    base_ns = int(1.6e18)
    step_ns = int(1e9 / fps)

    mm_w, mm_h = 530.0, 300.0
    ppm = np.array([1920.0 / mm_w, 1080.0 / mm_h], np.float32)

    for participant in participants:
        for stimulus in stimuli:
            d = os.path.join(root, participant, stimulus)
            os.makedirs(d, exist_ok=True)
            N = num_frames
            timestamps = base_ns + np.arange(N, dtype=np.int64) * step_ns \
                + rng.randint(0, 1000, N)
            timestamps.sort()

            # Screen video (30 fps, same length)
            screen_frames = np.zeros((N, 72, 128, 3), np.uint8)
            for i in range(N):
                screen_frames[i] = min(5 + 6 * i, 250)
            _write_video(os.path.join(d, 'screen.128x72.mp4'),
                         screen_frames, fps)
            # Stand-in for the full-resolution screen recording consumed by
            # the inference visualizer (load_full_frame_for_visualization;
            # the real dataset ships 1920x1080 — the overlay scales PoG
            # coordinates to the actual canvas size).
            full_screen = np.zeros((N, 216, 384, 3), np.uint8)
            for i in range(N):
                full_screen[i] = min(5 + 6 * i, 250)
            _write_video(os.path.join(d, 'screen.mp4'), full_screen, fps)
            np.savetxt(os.path.join(d, 'screen.timestamps.txt'),
                       timestamps, fmt='%d')

            for cam in cameras:
                cam_fps = 60 if cam == 'basler' else 30
                Nc = N * cam_fps // fps
                cam_ts = base_ns + np.arange(Nc, dtype=np.int64) * \
                    int(1e9 / cam_fps)
                # Small stand-in for the full camera frame video (the real
                # dataset ships 1080p; the inference CLI takes this path as
                # its --input-path identifier).
                full_frames = np.zeros((Nc, 108, 192, 3), np.uint8)
                for i in range(Nc):
                    full_frames[i] = min(5 + 6 * i, 250)
                _write_video(os.path.join(d, '%s.mp4' % cam),
                             full_frames, cam_fps)
                np.savetxt(os.path.join(d, '%s.timestamps.txt' % cam),
                           cam_ts, fmt='%d')

                # Geometry labels: camera rig + gaze toward sampled PoG
                cam_T = np.eye(4, dtype=np.float32)
                cam_T[:3, :3] = _rotation_np(rng.uniform(-0.1, 0.1, 2))
                cam_T[:3, 3] = [rng.uniform(-30, 30), rng.uniform(-15, 15),
                                rng.uniform(-5, 5)]
                inv_cam_T = np.linalg.inv(cam_T).astype(np.float32)

                o_mid = np.stack([
                    rng.uniform(-30, 30, Nc), rng.uniform(-20, 20, Nc),
                    rng.uniform(550, 650, Nc)], -1).astype(np.float32)
                left_o = o_mid + np.array([31.0, 0, 0], np.float32)
                right_o = o_mid - np.array([31.0, 0, 0], np.float32)
                head_pitchyaw = rng.uniform(-0.2, 0.2, 2)
                head_R = np.tile(_rotation_np(head_pitchyaw), (Nc, 1, 1))
                head_rvec = np.tile(
                    _rvec_from_R(_rotation_np(head_pitchyaw)), (Nc, 1))

                PoG_px = np.stack([rng.uniform(200, 1700, Nc),
                                   rng.uniform(150, 950, Nc)],
                                  -1).astype(np.float32)
                PoG_mm = PoG_px / ppm
                cam_T_b = np.tile(cam_T, (Nc, 1, 1))
                g_left = _combined_gaze(left_o, PoG_mm, head_R, cam_T_b)
                g_right = _combined_gaze(right_o, PoG_mm, head_R, cam_T_b)

                # Eyes video: per-frame pupil-disc gaze encoding. The strip
                # is [right | left] (the LEFT patch is the right half,
                # reference eve_sequences.py:283-285); a thin top band
                # encodes the frame index (5 + 6*i) for frame-exactness
                # probes, clear of the disc excursion range.
                if appearance == 'adversarial':
                    lat_l = sample_appearance_latents(rng, (Nc,))
                    lat_r = sample_appearance_latents(rng, (Nc,))
                    left_half = render_gaze_patches_adversarial(
                        g_left, eyes_size, lat_l)
                    right_half = render_gaze_patches_adversarial(
                        g_right, eyes_size, lat_r)
                else:
                    left_half = render_gaze_patches(g_left, eyes_size)
                    right_half = render_gaze_patches(g_right, eyes_size)
                eyes_frames = np.concatenate([right_half, left_half], axis=2)
                band = max(eyes_size // 12, 2)
                for i in range(Nc):
                    eyes_frames[i, :band] = min(5 + 6 * i, 250)
                _write_video(os.path.join(d, '%s_eyes.mp4' % cam),
                             eyes_frames, cam_fps)

                ones = np.ones(Nc, np.uint8)
                with h5py.File(os.path.join(d, '%s.h5' % cam), 'w') as f:
                    def grp(name, data, validity=None):
                        g = f.create_group(name)
                        g.create_dataset('data', data=data)
                        g.create_dataset(
                            'validity',
                            data=ones if validity is None else validity)

                    grp('left_o', left_o)
                    grp('right_o', right_o)
                    grp('left_R', head_R)
                    grp('right_R', head_R)
                    grp('head_rvec', head_rvec.astype(np.float32))
                    grp('left_h', rng.uniform(
                        -0.3, 0.3, (Nc, 2)).astype(np.float32))
                    grp('right_h', rng.uniform(
                        -0.3, 0.3, (Nc, 2)).astype(np.float32))
                    grp('left_p', rng.uniform(2, 5, Nc).astype(np.float32))
                    grp('right_p', rng.uniform(2, 5, Nc).astype(np.float32))
                    grp('left_g_tobii', g_left.astype(np.float32))
                    grp('right_g_tobii', g_right.astype(np.float32))
                    grp('left_PoG_tobii', PoG_px)
                    grp('right_PoG_tobii', PoG_px.copy())
                    f.create_dataset('camera_transformation', data=cam_T)
                    f.create_dataset('inv_camera_transformation',
                                     data=inv_cam_T)
                    f.create_dataset('millimeters_per_pixel',
                                     data=(1.0 / ppm).astype(np.float32))
                    f.create_dataset('pixels_per_millimeter', data=ppm)
    return root


def _rvec_from_R(R):
    """Rotation matrix -> rotation vector (inverse Rodrigues), numpy."""
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-8:
        return np.zeros(3, np.float32)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(theta))
    return (theta * axis).astype(np.float32)
