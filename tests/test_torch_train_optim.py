"""The port's optimizer, schedule and clipping against eve_tpu's, on the CPU.

- The LR schedule over updates 0-200 for every strategy, with and without
  warmup and the ``reference_compat_lr_schedule`` quirk, against
  eve_tpu's ``_schedule_array``: rtol 1e-6 plus 2e-6 of the largest LR
  (eve_tpu computes in float32, the port in float64; the cyclic ramp
  passes near 0).
- A 100-update trajectory on toy parameters with fixed gradients (no
  model, so no chaos), the pattern of ``tests/test_trajectory_parity.py``:
  the port's ``build_optimizer`` + ``clip_gradients`` + Adam against
  eve_tpu's optax chain, per update, covering the LR multipliers, the
  frozen subtree, norm clipping (active on some updates, not on others)
  and value clipping. Tolerance: rtol 2e-5 + 1e-5 per update, atol 3e-7
  per update: one update agrees to float32 rounding, and Adam's rsqrt
  compounds it linearly.
- The same trajectory with ``torch.nn.utils.clip_grad_norm_`` (which
  divides by ``norm + 1e-6``) in place of ``clip_gradients`` leaves that
  tolerance, so the trajectory test catches the trap.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.train import optim as joptim
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.train import optim as toptim

UPDATES_PER_EPOCH = 5


def _both_configs(overrides):
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_dict(overrides)
        tx, schedule = joptim.build_optimizer(jc, UPDATES_PER_EPOCH)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_dict(overrides)
    return tx, schedule, tc


@pytest.mark.parametrize('compat', [False, True], ids=['intended', 'compat'])
@pytest.mark.parametrize('warmup', [0.0, 2.0], ids=['nowarm', 'warm2'])
@pytest.mark.parametrize('strategy', ['none', 'exponential', 'cyclic'])
def test_schedule_matches_eve_tpu(strategy, warmup, compat):
    overrides = {'batch_size': 4, 'base_learning_rate': 0.002,
                 'num_warmup_epochs': warmup, 'lr_decay_strategy': strategy,
                 'lr_decay_factor': 0.5, 'lr_decay_epoch_interval': 1.5,
                 'reference_compat_lr_schedule': compat}
    _, jschedule, tc = _both_configs(overrides)
    tschedule = toptim.make_schedule(tc, UPDATES_PER_EPOCH)
    updates = np.arange(201)
    want = np.asarray(jax.vmap(jschedule)(jnp.asarray(updates)))
    got = np.array([tschedule(int(u)) for u in updates])
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2e-6 * np.abs(want).max())
    assert len(np.unique(np.round(got, 12))) > (1 if strategy != 'none'
                                                or warmup else 0)


def test_unknown_strategy_raises():
    tc = tconfig.Config()
    tc.import_dict({'lr_decay_strategy': 'cosine'})
    with pytest.raises(ValueError, match='cosine'):
        toptim.make_schedule(tc, 5)


def _toy_init():
    rs = np.random.RandomState(11)

    def t(*shape):
        return (0.1 * rs.normal(size=shape)).astype(np.float32)

    return {'eye_net': {'w': t(6, 4), 'b': t(4)},
            'refine_net': {'k': t(3, 3, 2, 2), 'g': t(2)}}


def _toy_grads(step, scales=(3.0, 0.05)):
    """Per-update gradients; the scale alternates so that norm clipping
    is active on some updates and not on others."""
    rs = np.random.RandomState(500 + step)
    scale = scales[0] if step % 3 == 0 else scales[1]

    def t(*shape):
        return (scale * rs.normal(size=shape)).astype(np.float32)

    return {'eye_net': {'w': t(6, 4), 'b': t(4)},
            'refine_net': {'k': t(3, 3, 2, 2), 'g': t(2)}}


class _Sub(torch.nn.Module):
    def __init__(self, tensors):
        super().__init__()
        for n, v in tensors.items():
            self.register_parameter(n, torch.nn.Parameter(torch.tensor(v)))


class _Toy(torch.nn.Module):
    def __init__(self, init, frozen):
        super().__init__()
        self.eye_net = _Sub(init['eye_net'])
        self.refine_net = _Sub(init['refine_net'])
        if frozen:
            self.eye_net.requires_grad_(False)


def _run(overrides, num_updates, clip=None, scales=(3.0, 0.05)):
    """Both optimizers over the same gradient stream; yields per update
    ``(port params, eve_tpu params)`` and the clip activity."""
    tx, _, tc = _both_configs(overrides)
    init = _toy_init()
    model = _Toy(init, tc.eye_net_frozen)
    optimizer = toptim.build_optimizer(tc, model)
    schedule = toptim.make_schedule(tc, UPDATES_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = tx.init(params)

    @jax.jit
    def apply(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return (jax.tree_util.tree_map(lambda p, u: p + u, params, updates),
                opt_state)

    clipped = 0
    for update in range(num_updates):
        grads = _toy_grads(update, scales)
        for sub, values in grads.items():
            for n, p in getattr(model, sub).named_parameters():
                if p.requires_grad:
                    p.grad = torch.tensor(values[n])
        gs = toptim.trainable_gradients(optimizer)
        if clip is not None:
            norm = clip(gs)
        else:
            norm = toptim.clip_gradients(gs, tc.gradient_clip_by,
                                         tc.gradient_clip_amount)
        clipped += int(float(norm) >= tc.gradient_clip_amount)
        assert float(norm) > 0
        toptim.set_learning_rate(optimizer, schedule(update))
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        params, opt_state = apply(params, opt_state,
                                  jax.tree_util.tree_map(jnp.asarray, grads))
        port = {sub: {n: p.detach().numpy().copy()
                      for n, p in getattr(model, sub).named_parameters()}
                for sub in ('eye_net', 'refine_net')}
        yield update, port, jax.tree_util.tree_map(np.asarray, params)
    assert clip is not None or 0 < clipped < num_updates or \
        tc.gradient_clip_by == 'value', clipped


def _assert_close(update, port, ref):
    for sub, values in ref.items():
        for n, want in values.items():
            np.testing.assert_allclose(
                port[sub][n], want, rtol=2e-5 + 1e-5 * update,
                atol=3e-7 * (1 + update),
                err_msg='update %d %s/%s' % (update, sub, n))


BASE = {'batch_size': 2, 'base_learning_rate': 0.02, 'weight_decay': 0.001,
        'do_gradient_clipping': True, 'gradient_clip_by': 'norm',
        'gradient_clip_amount': 1.0, 'num_warmup_epochs': 2.0,
        'lr_decay_strategy': 'exponential', 'lr_decay_factor': 0.5,
        'lr_decay_epoch_interval': 2.0}


@pytest.mark.parametrize('extra', [
    {},
    {'reference_compat_lr_schedule': True},
    {'eye_net_learning_rate_multiplier': 0.5,
     'refine_net_learning_rate_multiplier': 2.0},
    {'eye_net_frozen': True},
    {'eye_net_frozen': True, 'refine_net_learning_rate_multiplier': 2.0},
    {'gradient_clip_by': 'value', 'gradient_clip_amount': 0.05},
], ids=['intended', 'compat-quirk', 'per-submodule-lr', 'frozen-eye',
        'frozen-eye-lr', 'clip-by-value'])
def test_optimizer_trajectory_matches_eve_tpu(extra):
    init = _toy_init()
    last = None
    for update, port, ref in _run(dict(BASE, **extra), 100):
        _assert_close(update, port, ref)
        last = port
    if extra.get('eye_net_frozen'):
        for n, v in init['eye_net'].items():
            np.testing.assert_array_equal(last['eye_net'][n], v)


def test_clip_grad_norm_trap_leaves_the_tolerance():
    """torch's clip_grad_norm_ (norm + 1e-6) drifts out of the trajectory
    tolerance where the port's optax clip stays in: with gradient norms of
    ~2e-4 (clipped to 1e-4) and ~4e-6 (not clipped), the 1e-6 is a
    visible share of the norm."""
    overrides = dict(BASE, gradient_clip_amount=1e-4)
    scales = (2.5e-5, 5e-7)
    for update, port, ref in _run(overrides, 30, scales=scales):
        _assert_close(update, port, ref)
    with pytest.raises(AssertionError):
        for update, port, ref in _run(overrides, 30, scales=scales,
                                      clip=_clip_grad_norm_(1e-4)):
            _assert_close(update, port, ref)


def _clip_grad_norm_(amount):
    """``torch.nn.utils.clip_grad_norm_`` over bare gradient tensors."""
    def clip(grads):
        holders = []
        for g in grads:
            p = torch.nn.Parameter(torch.zeros_like(g))
            p.grad = g
            holders.append(p)
        return torch.nn.utils.clip_grad_norm_(holders, amount)
    return clip


def test_clip_gradients_is_optax():
    """Below the limit the gradients are untouched (bitwise); above, each
    is ``g / norm * amount`` as optax computes it."""
    rs = np.random.RandomState(3)
    grads = [torch.tensor(rs.normal(size=s).astype(np.float32))
             for s in ((5, 3), (7,))]
    small = [0.01 * g for g in grads]
    kept = [g.clone() for g in small]
    toptim.clip_gradients(small, 'norm', 10.0)
    assert all(torch.equal(a, b) for a, b in zip(small, kept))
    big = [g.clone() for g in grads]
    norm = toptim.clip_gradients(big, 'norm', 0.5)
    want = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g.numpy()) for g in grads], None)[0]
    for a, b in zip(big, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    np.testing.assert_allclose(
        float(norm), np.sqrt(sum(float((g ** 2).sum()) for g in grads)),
        rtol=1e-6)
