"""Gaze geometry ops on tensors, batched over arbitrary leading dimensions.

The PyTorch counterpart of ``eve_tpu/ops/geometry.py``, with the same
conventions: angles are ``(pitch, yaw)`` in radians; x right, y down, z
forward; gaze vectors are stored in *user* perspective (negated camera
rays). Every function broadcasts over leading dims ``(..., F)``.

The 3x3 products are written out as broadcast multiplies and sums, so they
run in float32 on every device: no matrix unit, and so no TF32 rounding on
the card. The guards that keep gradients finite at zero vectors, at the
pitch poles and at the zero rotation vector are the same as eve_tpu's.
"""

import math

import torch

SCREEN_W_PX = 1920.0
SCREEN_H_PX = 1080.0


def _matvec(m, v):
    """(..., 3, 3) x (..., 3) -> (..., 3) in float32 elementwise math."""
    return (m * v.unsqueeze(-2)).sum(-1)


def _matmul(a, b):
    """(..., 3, 3) x (..., 3, 3) -> (..., 3, 3) in float32 elementwise math."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _safe_norm(a, dim=-1, keepdim=False, eps=1e-14):
    """L2 norm with a finite (zero) gradient at ``a == 0``."""
    return torch.sqrt(torch.sum(a * a, dim=dim, keepdim=keepdim) + eps)


def pitchyaw_to_vector(a):
    """(..., 2) pitch/yaw -> (..., 3) unit vector; (..., 3) -> normalized."""
    if a.shape[-1] == 2:
        sin = torch.sin(a)
        cos = torch.cos(a)
        return torch.stack([
            cos[..., 0] * sin[..., 1],
            sin[..., 0],
            cos[..., 0] * cos[..., 1],
        ], dim=-1)
    if a.shape[-1] == 3:
        # torch.nn.functional.normalize: x / max(||x||, eps), eps=1e-12
        norm = _safe_norm(a, keepdim=True)
        return a / torch.clamp(norm, min=1e-12)
    raise ValueError('Cannot convert tensor of trailing dim %d' % a.shape[-1])


def vector_to_pitchyaw(a):
    """(..., 3) vector -> (..., 2) pitch/yaw."""
    if a.shape[-1] == 2:
        return a
    if a.shape[-1] != 3:
        raise ValueError('Cannot convert tensor of trailing dim %d' % a.shape[-1])
    # Zero vectors (padded frames) map to (0, 0), as atan2(0, 0) does, but
    # atan2's gradient there is NaN: swap in the frontal vector first.
    sq = torch.sum(a * a, dim=-1, keepdim=True)
    frontal = torch.zeros_like(a)
    frontal[..., 2] = 1.0
    a = torch.where(sq > 1e-12, a, frontal)
    norm_a = a / (_safe_norm(a, keepdim=True) + 1e-7)
    # At the pitch poles (x == z == 0) the yaw is undefined and atan2's
    # gradient is NaN again: swap in (x, z) = (0, 1) there.
    x, y, z = norm_a[..., 0], norm_a[..., 1], norm_a[..., 2]
    off_pole = (x * x + z * z) > 1e-12
    x = torch.where(off_pole, x, torch.zeros_like(x))
    z = torch.where(off_pole, z, torch.ones_like(z))
    return torch.stack([torch.asin(y), torch.atan2(x, z)], dim=-1)


def pitchyaw_to_rotation(a):
    """(..., 2) pitch/yaw (or (..., 3) vector) -> (..., 3, 3) R_yaw @ R_pitch."""
    if a.shape[-1] == 3:
        a = vector_to_pitchyaw(a)
    cos = torch.cos(a)
    sin = torch.sin(a)
    ones = torch.ones_like(cos[..., 0])
    zeros = torch.zeros_like(cos[..., 0])
    cp, cy = cos[..., 0], cos[..., 1]
    sp, sy = sin[..., 0], sin[..., 1]
    shape = a.shape[:-1] + (3, 3)
    m1 = torch.stack([ones, zeros, zeros,
                      zeros, cp, sp,
                      zeros, -sp, cp], dim=-1).reshape(shape)
    m2 = torch.stack([cy, zeros, sy,
                      zeros, ones, zeros,
                      -sy, zeros, cy], dim=-1).reshape(shape)
    return _matmul(m2, m1)


def rotation_to_vector(a):
    """(..., 3, 3) rotation -> (..., 3, 1): the rotated frontal vector."""
    return a[..., :, 2:3]


def apply_transformation(T, vec):
    """Homogeneous transform: (..., 4, 4) x (..., 3) -> (..., 3)."""
    if vec.shape[-1] == 2:
        vec = pitchyaw_to_vector(vec)
    return _matvec(T[..., :3, :3], vec) + T[..., :3, 3]


def apply_rotation(T, vec):
    """Rotation part only: (..., >=3, >=3) x (..., 3) -> (..., 3)."""
    if vec.shape[-1] == 2:
        vec = pitchyaw_to_vector(vec)
    return _matvec(T[..., :3, :3], vec)


def get_intersect_with_zero(o, g):
    """Intersect rays (origin ``o``, direction ``g``) with the z=0 plane."""
    numer = -o[..., 2]
    denom = g[..., 2] + 1e-7
    t = (numer / denom).unsqueeze(-1)
    return (o + t * g)[..., :2]


def to_screen_coordinates(origin, direction, rotation, reference_dict,
                          actual_screen_size=(SCREEN_W_PX, SCREEN_H_PX)):
    """Project a gaze to the screen; returns ``(PoG_mm, PoG_px)``.

    ``reference_dict`` holds ``inv_camera_transformation`` (..., 4, 4) and
    ``pixels_per_millimeter`` (..., 2). PoG_px is clamped to the screen.
    """
    direction = -pitchyaw_to_vector(direction)           # camera perspective
    direction = _matvec(rotation.transpose(-1, -2), direction)

    inv_camera_T = reference_dict['inv_camera_transformation']
    direction = apply_rotation(inv_camera_T, direction)
    origin = apply_transformation(inv_camera_T, origin)

    PoG_mm = get_intersect_with_zero(origin, direction)

    ppm = reference_dict['pixels_per_millimeter']
    PoG_px = torch.stack([
        torch.clamp(PoG_mm[..., 0] * ppm[..., 0], 0.0,
                    float(actual_screen_size[0])),
        torch.clamp(PoG_mm[..., 1] * ppm[..., 1], 0.0,
                    float(actual_screen_size[1])),
    ], dim=-1)
    return PoG_mm, PoG_px


def calculate_combined_gaze_direction(avg_origin, avg_PoG, head_rotation,
                                      camera_transformation):
    """Combined gaze direction from the 3D origin and screen-plane PoG (mm)."""
    PoG_3D = torch.cat([avg_PoG, torch.zeros_like(avg_PoG[..., :1])], dim=-1)
    PoG_3D = apply_transformation(camera_transformation, PoG_3D)
    direction = _matvec(head_rotation, PoG_3D - avg_origin)
    return vector_to_pitchyaw(-direction)                # user perspective


def apply_offset_augmentation(gaze_direction, head_rotation, kappa,
                              inverse_kappa=False):
    """Rotate a gaze by a per-sample kappa offset in head-relative space."""
    g = -pitchyaw_to_vector(gaze_direction)              # camera perspective
    g = -_matvec(head_rotation.transpose(-1, -2), g)     # user perspective

    kappa_vector = pitchyaw_to_vector(kappa)
    if inverse_kappa:
        kappa_vector = torch.cat(
            [-kappa_vector[..., :2], kappa_vector[..., 2:3]], dim=-1)

    head_relative_gaze_rotation = pitchyaw_to_rotation(vector_to_pitchyaw(g))
    g = -_matvec(head_relative_gaze_rotation, kappa_vector)
    g = -_matvec(head_rotation, g)
    return vector_to_pitchyaw(g)


def rodrigues(rvec):
    """Rotation vector (..., 3) -> rotation matrix (..., 3, 3).

    With the ``_safe_norm`` floor, theta >= 1e-7 everywhere, so the identity
    at ``rvec == 0`` emerges with a finite (zero) gradient and no branch.
    """
    theta = _safe_norm(rvec, keepdim=True)
    k = rvec / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    K = torch.stack([zeros, -kz, ky,
                     kz, zeros, -kx,
                     -ky, kx, zeros], dim=-1).reshape(rvec.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    s = torch.sin(theta).unsqueeze(-1)
    c = torch.cos(theta).unsqueeze(-1)
    return eye + s * K + (1.0 - c) * _matmul(K, K)


def angular_error_degrees(a, b):
    """Angular error in degrees between pitch/yaw (or 3D) gazes.

    Cosine similarity with eps, clamped to +-(1 - 1e-7) (1 - 1e-8 rounds to
    1.0 in float32, where acos' gradient is infinite), acos, degrees.
    """
    va = pitchyaw_to_vector(a) if a.shape[-1] == 2 else a
    vb = pitchyaw_to_vector(b) if b.shape[-1] == 2 else b
    na = _safe_norm(va)
    nb = _safe_norm(vb)
    dot = torch.sum(va * vb, dim=-1)
    sim = dot / torch.clamp(na * nb, min=1e-8)
    sim = torch.clamp(sim, -1.0 + 1e-7, 1.0 - 1e-7)
    return torch.acos(sim) * (180.0 / math.pi)
