"""Gradients of the port's losses against eve_tpu's, on the CPU.

The same numpy inputs go through each masked loss of both packages and
through ``jax.grad`` and torch's autograd, with the edge cases eve_tpu
guards: heatmap pixels at exactly 0 and 1 (where BCE's log term with the
infinite derivative gives no gradient), frames where prediction equals
label (the euclidean loss's sqrt at 0 stays finite, and the L1 loss takes
``jnp.abs``'s gradient of +1 there), invalid frames (no gradient) and a
clip with a single valid frame. Values and gradients agree within rtol
1e-5, atol 1e-7 (float32 sums in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu import losses as jlosses
from eve_tpu_torch import losses as tlosses

B, T = 3, 4


def _inputs(name, rng):
    validity = np.ones((B, T), np.float32)
    validity[0, 1] = 0
    validity[2, 1:] = 0          # one valid frame: no normalisation
    if name == 'cross_entropy_loss':
        pred = rng.uniform(0.01, 0.99, (B, T, 6, 8)).astype(np.float32)
        pred[0, 0, 0, :3] = 1.0  # saturated pixels
        pred[1, 2, 1, :2] = 0.0
        gt = rng.uniform(0, 1, pred.shape).astype(np.float32)
    elif name == 'angular_loss':
        pred = rng.uniform(-0.5, 0.5, (B, T, 2)).astype(np.float32)
        gt = rng.uniform(-0.5, 0.5, (B, T, 2)).astype(np.float32)
    else:
        pred = rng.normal(size=(B, T, 2)).astype(np.float32)
        gt = rng.normal(size=(B, T, 2)).astype(np.float32)
        gt[1, 3] = pred[1, 3]    # ssd == 0, |d| == 0
    return pred, gt, validity


@pytest.mark.parametrize('name', ['mse_loss', 'l1_loss', 'euclidean_loss',
                                  'angular_loss', 'cross_entropy_loss'])
def test_loss_value_and_gradient_match_eve_tpu(name):
    pred, gt, validity = _inputs(name, np.random.RandomState(0))
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    want, want_grad = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(gt), jnp.asarray(validity)))(
            jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(p, torch.from_numpy(gt), torch.from_numpy(validity))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grad = p.grad.numpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=1e-5,
                               atol=1e-7)
    assert not grad[0, 1].any()      # invalid frame
    if name == 'euclidean_loss':
        assert not grad[1, 3].any()
