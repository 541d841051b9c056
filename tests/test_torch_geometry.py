"""The port's geometry ops and losses against eve_tpu, on the CPU.

Same numpy inputs through ``eve_tpu.ops.geometry`` / ``eve_tpu.losses`` and
their ``eve_tpu_torch`` counterparts. Both compute in float32 with the same
operation order up to the 3-term dot products, so values agree to a few
float32 ulp (rtol 1e-5, atol 1e-5 on values of order 1-1000). Gradients
must stay finite where eve_tpu guards them: the pitch poles and zero
vectors of ``vector_to_pitchyaw``, the zero rotation vector of
``rodrigues``, identical Euclidean-loss inputs and saturated BCE pixels.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu import losses as jloss
from eve_tpu.ops import geometry as jgeo
from eve_tpu_torch import losses as tloss
from eve_tpu_torch.ops import geometry as tgeo

TOL = dict(rtol=1e-5, atol=1e-5)


def _rot(rng, lead):
    """Random rotations (..., 3, 3) from eve_tpu's rodrigues."""
    rvec = rng.uniform(-0.4, 0.4, lead + (3,)).astype(np.float32)
    return np.asarray(jgeo.rodrigues(jnp.asarray(rvec)))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture
def inputs():
    rng = np.random.RandomState(0)
    lead = (2, 3)
    return {
        'py': rng.uniform(-0.6, 0.6, lead + (2,)).astype(np.float32),
        'vec': rng.normal(size=lead + (3,)).astype(np.float32),
        'R': _rot(rng, lead),
        'T': np.concatenate([
            np.concatenate([_rot(rng, lead),
                            rng.uniform(-40, 40, lead + (3, 1))], -1),
            np.broadcast_to(np.array([0, 0, 0, 1.0]), lead + (1, 4))],
            -2).astype(np.float32),
        'o': np.stack([rng.uniform(-30, 30, lead), rng.uniform(-20, 20, lead),
                       rng.uniform(550, 650, lead)], -1).astype(np.float32),
        'ppm': np.broadcast_to(np.array([3.62, 3.6], np.float32),
                               lead + (2,)).copy(),
        'pog_mm': rng.uniform(50, 500, lead + (2,)).astype(np.float32),
        'rvec': rng.uniform(-1, 1, lead + (3,)).astype(np.float32),
    }


@pytest.mark.parametrize('name', [
    'pitchyaw_to_vector', 'vector_to_pitchyaw', 'pitchyaw_to_rotation',
    'rodrigues', 'angular_error_degrees', 'apply_transformation',
    'apply_rotation', 'get_intersect_with_zero', 'to_screen_coordinates',
    'calculate_combined_gaze_direction', 'apply_offset_augmentation',
    'rotation_to_vector'])
def test_geometry_matches_eve_tpu(inputs, name):
    i = inputs
    args = {
        'pitchyaw_to_vector': (i['py'],),
        'vector_to_pitchyaw': (i['vec'],),
        'pitchyaw_to_rotation': (i['py'],),
        'rodrigues': (i['rvec'],),
        'angular_error_degrees': (i['py'], i['py'][::-1]),
        'apply_transformation': (i['T'], i['vec']),
        'apply_rotation': (i['T'], i['py']),
        'get_intersect_with_zero': (i['o'], i['vec']),
        'calculate_combined_gaze_direction': (i['o'], i['pog_mm'], i['R'],
                                              i['T']),
        'apply_offset_augmentation': (i['py'], i['R'], 0.05 * i['py'][::-1]),
        'rotation_to_vector': (i['R'],),
    }
    if name == 'to_screen_coordinates':
        ref_dict = {'inv_camera_transformation': i['T'],
                    'pixels_per_millimeter': i['ppm']}
        ref = jgeo.to_screen_coordinates(
            jnp.asarray(i['o']), jnp.asarray(i['py']), jnp.asarray(i['R']),
            {k: jnp.asarray(v) for k, v in ref_dict.items()})
        ours = tgeo.to_screen_coordinates(
            _t(i['o']), _t(i['py']), _t(i['R']),
            {k: _t(v) for k, v in ref_dict.items()})
        for a, b in zip(ours, ref):
            # Screen px reach ~1e3 and go through a 1/z division.
            _close(a, b, rtol=1e-5, atol=1e-3)
        return
    ref = getattr(jgeo, name)(*(jnp.asarray(a) for a in args[name]))
    ours = getattr(tgeo, name)(*(_t(a) for a in args[name]))
    _close(ours, ref)


def test_vector_to_pitchyaw_grads_finite_at_poles_and_zero():
    # The points eve_tpu's own finiteness sweep guards: both unit pitch
    # poles, the zero vector, and a regular gaze.
    pts = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0],
                    [0.3, 0.2, 0.9]], np.float32)
    v = _t(pts).requires_grad_(True)
    out = tgeo.vector_to_pitchyaw(v)
    _close(out, jgeo.vector_to_pitchyaw(jnp.asarray(pts)))
    (g,) = torch.autograd.grad(out.sum(), v)
    assert torch.isfinite(g).all()
    ref = jax.grad(lambda x: jgeo.vector_to_pitchyaw(x).sum())(
        jnp.asarray(pts))
    _close(g, ref, rtol=1e-4, atol=1e-6)


def test_rodrigues_grad_finite_at_zero():
    rvec = torch.zeros((2, 3), requires_grad=True)
    R = tgeo.rodrigues(rvec)
    torch.testing.assert_close(R, torch.eye(3).expand(2, 3, 3))
    (g,) = torch.autograd.grad(R.sum(), rvec)
    assert torch.isfinite(g).all()


def test_angular_error_grad_finite_at_identical_gazes():
    a = _t([[0.1, -0.2], [0.0, 0.0]]).requires_grad_(True)
    err = tgeo.angular_error_degrees(a, a.detach())
    (g,) = torch.autograd.grad(err.sum(), a)
    assert torch.isfinite(g).all()


@pytest.fixture
def loss_inputs():
    rng = np.random.RandomState(1)
    validity = np.ones((3, 4), np.float32)
    validity[0, 1:] = 0.0  # one valid frame: no per-item normalisation
    validity[1, 2] = 0.0
    return {
        'pred': rng.normal(size=(3, 4, 2)).astype(np.float32),
        'gt': rng.normal(size=(3, 4, 2)).astype(np.float32),
        'hm_pred': rng.uniform(0, 1, (3, 4, 9, 16)).astype(np.float32),
        'hm_gt': rng.uniform(0, 1, (3, 4, 9, 16)).astype(np.float32),
        'validity': validity,
    }


@pytest.mark.parametrize('name', ['mse_loss', 'l1_loss', 'euclidean_loss',
                                  'angular_loss', 'cross_entropy_loss'])
def test_losses_match_eve_tpu(loss_inputs, name):
    i = loss_inputs
    if name == 'cross_entropy_loss':
        pred, gt = i['hm_pred'].copy(), i['hm_gt']
        pred[0, 0, 0, :3] = [0.0, 1.0, 0.5]  # saturated pixels
    else:
        pred, gt = i['pred'], i['gt']
    ref = getattr(jloss, name)(jnp.asarray(pred), jnp.asarray(gt),
                               jnp.asarray(i['validity']))
    p = _t(pred).requires_grad_(True)
    ours = getattr(tloss, name)(p, _t(gt), _t(i['validity']))
    _close(ours, ref)
    (g,) = torch.autograd.grad(ours, p)
    assert torch.isfinite(g).all()
    ref_g = jax.grad(lambda x: getattr(jloss, name)(
        x, jnp.asarray(gt), jnp.asarray(i['validity'])))(jnp.asarray(pred))
    _close(g, ref_g, rtol=1e-4, atol=1e-6)


def test_euclidean_loss_grad_finite_at_zero_distance():
    p = torch.zeros((2, 3, 2), requires_grad=True)
    loss = tloss.euclidean_loss(p, torch.zeros((2, 3, 2)), torch.ones((2, 3)))
    (g,) = torch.autograd.grad(loss, p)
    assert float(loss.detach()) == 0.0 and torch.isfinite(g).all()


def test_masked_mean_normalises_only_above_one_valid_frame():
    loss = torch.tensor([[2.0, 4.0, 6.0], [3.0, 5.0, 7.0]])
    validity = torch.tensor([[1.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    # item 0: (2 + 4) / 2 = 3; item 1: one valid frame, sum 5 kept as is.
    assert float(tloss.masked_mean(loss, validity)) == pytest.approx(4.0)
    ref = jloss.masked_mean(jnp.asarray(loss.numpy()),
                            jnp.asarray(validity.numpy()))
    assert float(ref) == pytest.approx(4.0)
