"""One training step of the port against eve_tpu's, on the CPU.

Both packages build the model from the same JSON (``configs/refine_net.json``
with a frozen EyeNet, and ``configs/eye_net.json``), with eve_tpu's
``init_params`` weights perturbed so that every head is live, carried into
the port with ``utils.convert``. The same numpy-seeded batch, with the
kappas injected (the two packages' random streams differ), goes through
eve_tpu's loss and gradient (the jnp heatmap path) and its optax chain, and
through the port's ``train_step``.

Sizes: B = 2, T = 3; 32x32 eyes with the RefineNet (a frozen EyeNet only
feeds the initial PoG), 48x48 for the EyeNet step (at 32x32 ResNet-18's
layer4 is 1x1 and instance norm zeroes every convolution's gradient).

Tolerances, with their reasons:
- ``full_loss``: rtol 1e-5 (float32 sums in another order).
- Gradients: each element within ``elem`` of its tensor's largest
  element, and each tensor's L2 error within ``l2`` of its norm, plus
  1e-5 of the model's largest gradient (for the biases an instance norm
  cancels, whose true gradient is 0): EyeNet 2e-3 and 1e-3, float32 sums
  in other orders through ~40 layers; RefineNet 0.1 and 3e-2, because its
  gradient is ill-conditioned in float32: scaling the port's own weights
  by (1 + 1e-7 N(0, 1)) moves its gradient by up to 1% (L2) and 2.8% of a
  tensor's largest element (measured), as max-pool windows whose two
  largest inputs lie within rounding route the gradient to either.
- Parameters after 1 and 3 updates: Adam moves an element by at most lr an
  update whatever its gradient, and by exactly ``lr * sign(g)`` at the
  first update, so an element whose gradient (clipped, plus the coupled
  weight decay) lies within the gradient tolerance of 0 may move either
  way in the two frameworks. So every element's update agrees within
  twice the step bound (the sum of the LRs), and 99% within ``update`` of it
  (EyeNet 2%, RefineNet 10%). The LR is small (2e-5) to keep 3 updates
  inside the chaos horizon: an element the two frameworks move apart
  changes the next gradients in proportion.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import eve as jeve
from eve_tpu.train import optim as joptim
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs')
B, T = 2, 3
UPDATES_PER_EPOCH = 4
GRAD_GLOBAL_ATOL = 1e-5
# Per case: (element, L2, update) tolerances; see the module docstring.
TOLERANCES = {'eye_net': (2e-3, 1e-3, 2e-2), 'refine_net': (0.1, 3e-2, 0.1)}

CASES = {
    'refine_net': ('refine_net.json', 32, {
        'eye_net_load_pretrained': False, 'batch_size': B,
        'base_learning_rate': 1e-5, 'weight_decay': 0.001,
        'gradient_clip_amount': 0.5}),
    'eye_net': ('eye_net.json', 48, {'batch_size': B,
                                     'base_learning_rate': 1e-5}),
}


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)



def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


def _configs(json_name, overrides):
    path = os.path.join(CONFIGS, json_name)
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(path)
        jc.import_dict(overrides)
        jspec = jeve.EveSpec.from_config(jc)
        tx, schedule = joptim.build_optimizer(jc, UPDATES_PER_EPOCH)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(path)
    tc.import_dict(overrides)
    return jspec, tx, schedule, tc


def make_batch(seed, eyes, batch_size=B, sigma=3.0):
    """A synthetic batch with injected kappas, numpy."""
    rng = np.random.RandomState(seed)
    batch = make_synthetic_batch(rng, batch_size=batch_size, sequence_len=T,
                                 eyes_size=eyes, frame_dtype=np.uint8)
    for side in ('left', 'right'):
        kappa = np.radians(sigma) * rng.normal(size=(batch_size, 2))
        batch[side + '_kappa_fake'] = np.repeat(
            kappa[:, None].astype(np.float32), T, axis=1)
    return batch


def initial_params(jspec):
    tree = jax.jit(functools.partial(jeve.init_params, jspec))(
        jax.random.PRNGKey(0))
    tree = _perturb(tree, np.random.RandomState(0))
    if 'refine_net' in tree:
        tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


def grad_tolerance(grads, top, elem):
    """The gradient test's absolute element tolerance of each tensor."""
    return {k: elem * np.abs(g).max() + GRAD_GLOBAL_ATOL * top
            for k, g in grads.items()}


def jax_trajectory(jspec, tx, params, batch, updates):
    """eve_tpu: full_loss of the first step, the gradients of every step
    (as port state dicts of numpy arrays) and the parameters after each
    update (the train step's loss, grad and tx.update)."""
    def loss_fn(p):
        return jeve.forward(jspec, p, batch, training=True)['full_loss']

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    @jax.jit
    def apply(p, opt_state, grads):
        upd, opt_state = tx.update(grads, opt_state, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), opt_state

    opt_state = tx.init(params)
    losses, grads_seen, after = [], [], [params]
    for _ in range(updates):
        loss, grads = grad_fn(params)
        losses.append(float(loss))
        grads_seen.append({k: v.numpy() for k, v in convert.eve_state_dict(
            jax.tree_util.tree_map(np.asarray, grads)).items()})
        params, opt_state = apply(params, opt_state, grads)
        after.append(jax.tree_util.tree_map(np.asarray, params))
    return losses[0], grads_seen, after


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    json_name, eyes, overrides = CASES[request.param]
    jspec, tx, schedule, tc = _configs(json_name, overrides)
    params = initial_params(jspec)
    batch = make_batch(1, eyes)
    ref = jax_trajectory(jspec, tx, params, batch, 3)
    return request.param, tc, params, batch, ref, schedule


def _port_state(tc, params):
    spec = teve.EveSpec.from_config(tc)
    model = teve.build_model(spec, convert.eve_state_dict(params), 'cpu')
    return tstep.create_train_state(tc, model, UPDATES_PER_EPOCH)


def _trainable(ref_grads, model):
    """The reference gradients of the port's trainable parameters, and
    the largest element among them."""
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    grads = {k: g for k, g in ref_grads.items() if k in names}
    return grads, max(float(np.abs(g).max()) for g in grads.values())


def test_full_loss_and_gradients_match_eve_tpu(case):
    name, tc, params, batch, (ref_loss, ref_grads, _), _ = case
    state = _port_state(tc, params)
    out = tstep.accumulate_gradients(state.model,
                                     teve.batch_to_tensors(batch, 'cpu'))
    np.testing.assert_allclose(out['full_loss'].item(), ref_loss, rtol=1e-5)
    if name == 'refine_net':  # frozen: no gradient, no graph
        assert all(p.grad is None and not p.requires_grad
                   for p in state.model.eye_net.parameters())
    want, top = _trainable(ref_grads[0], state.model)
    assert top > 0
    elem, l2, _ = TOLERANCES[name]
    tol = grad_tolerance(want, top, elem)
    for n, p in state.model.named_parameters():
        if n in want:
            got = (np.zeros_like(want[n]) if p.grad is None
                   else p.grad.numpy())
            np.testing.assert_allclose(got, want[n], rtol=0, atol=tol[n],
                                       err_msg=n)
            assert np.linalg.norm(got - want[n]) <= (
                l2 * np.linalg.norm(want[n]) +
                GRAD_GLOBAL_ATOL * top * np.sqrt(got.size)), n


def assert_updates_agree(got, want, bound, update_rtol, what):
    """Port and reference updates of a state dict: all within twice the
    step bound, 99% within ``update_rtol`` of it (module docstring)."""
    off = total = 0
    for k, d in got.items():
        err = np.abs(d - want[k])
        assert err.max(initial=0) <= 2.02 * bound, (what, k, err.max())
        off += int((err > update_rtol * bound + 1e-7).sum())
        total += err.size
    assert off <= 0.01 * total, (what, off, total)


def test_parameters_after_updates_match_eve_tpu(case):
    name, tc, params, batch, (_, _, ref_params), schedule = case
    state = _port_state(tc, params)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    tbatch = teve.batch_to_tensors(batch, 'cpu')
    for update in range(3):
        metrics = tstep.train_step(state, tbatch)
        assert not bool(metrics['nan_flag'])
        assert state.step == update + 1
        if update not in (0, 2):
            continue
        want_sd = convert.eve_state_dict(ref_params[update + 1])
        got, want = {}, {}
        for k, v in state.model.state_dict().items():
            got[k] = (v - before[k]).numpy()
            want[k] = (want_sd[k] - before[k]).numpy()
            if name == 'refine_net' and k.startswith('eye_net.'):
                assert not got[k].any() and not want[k].any(), k  # frozen
        assert_updates_agree(got, want,
                             sum(schedule(u) for u in range(update + 1)),
                             TOLERANCES[name][2],
                             'after %d updates' % (update + 1))


def test_gradient_accumulation_matches_one_full_batch():
    """Two micro-batches of 2 clips with gradient_accumulation_steps = 2
    take the same update as one batch of 4: each loss is a mean over its
    clips, so the two means' average is the 4-clip mean. Updates agree as
    in the test above (the micro-batches' convolutions round otherwise)."""
    json_name, eyes, overrides = CASES['refine_net']
    jspec, _, _, tc = _configs(json_name, dict(overrides, batch_size=4))
    params = initial_params(jspec)
    batch = make_batch(2, eyes, batch_size=4)
    full = _port_state(tc, params)
    tcfg = tconfig.Config()
    tcfg.import_json(os.path.join(CONFIGS, json_name))
    tcfg.import_dict(dict(overrides, batch_size=4,
                          gradient_accumulation_steps=2))
    accum = _port_state(tcfg, params)
    assert accum.accumulation_steps == 2
    before = {k: v.clone() for k, v in full.model.state_dict().items()}
    tstep.train_step(full, teve.batch_to_tensors(batch, 'cpu'))
    for half in (slice(0, 2), slice(2, 4)):
        micro = {k: v[half] for k, v in batch.items()}
        tstep.train_step(accum, teve.batch_to_tensors(micro, 'cpu'))
        if half.start == 0:  # no update after the first micro-batch
            for k, v in accum.model.state_dict().items():
                assert torch.equal(v, before[k]), k
    assert accum.updates == full.updates == 1
    a, b = full.model.state_dict(), accum.model.state_dict()
    assert_updates_agree({k: (b[k] - before[k]).numpy() for k in a},
                         {k: (a[k] - before[k]).numpy() for k in a},
                         full.schedule(0), TOLERANCES['refine_net'][2],
                         'accumulated')


def test_kappas_drawn_on_a_cpu_generator():
    """Without injected kappas the training forward draws them from the
    generator (same seed, same draw), and refuses to run without one."""
    json_name, eyes, overrides = CASES['refine_net']
    _, _, _, tc = _configs(json_name, overrides)
    spec = teve.EveSpec.from_config(tc)
    kl, kr = teve.draw_kappas(spec, 3, torch.Generator().manual_seed(5))
    kl2, _ = teve.draw_kappas(spec, 3, torch.Generator().manual_seed(5))
    assert kl.shape == kr.shape == (3, 2) and torch.equal(kl, kl2)
    assert not torch.equal(kl, kr)
    np.testing.assert_allclose(
        float(torch.cat([kl, kr]).std()), np.radians(3.0), rtol=0.8)
    zp = teve.EveSpec(refine_net_offset_augmentation_zero_prob=1.0)
    assert not teve.draw_kappas(zp, 3, torch.Generator())[0].any()
    batch = teve.batch_to_tensors(make_batch(3, eyes), 'cpu')
    del batch['left_kappa_fake'], batch['right_kappa_fake']
    labels = teve.calculate_additional_labels(
        spec, batch, torch.Generator().manual_seed(5), training=True)
    assert torch.equal(labels['left_kappa_fake'][:, 0], kl[:B])
    assert torch.equal(labels['left_kappa_fake'][:, 2], kl[:B])
    with pytest.raises(ValueError, match='Generator'):
        teve.calculate_additional_labels(spec, batch, None, training=True)
    batch['left_kappa_fake'] = labels['left_kappa_fake']
    with pytest.raises(ValueError, match='both'):
        teve.calculate_additional_labels(spec, batch, None, training=True)


@pytest.mark.parametrize('multi_source', [False, True],
                         ids=['one source', 'two sources'])
def test_step_spans_with_a_profiler(case, multi_source):
    """Under a profiler each step gives one ``train.step`` with
    ``train.forward``, ``train.backward`` and ``train.update`` children
    (no event pair off a card), and the parameters equal those of the same
    steps with no profiler, bit for bit."""
    from eve_tpu_torch import tracing
    from tests.test_torch_tracing import all_threads_profiler
    _, tc, params, batch, _, _ = case
    tbatch = teve.batch_to_tensors(batch, 'cpu')

    def train(steps):
        state = _port_state(tc, params)
        for i in range(steps):
            if multi_source:
                tstep.multi_source_train_step(
                    state, {'a': tbatch, 'b': tbatch},
                    {t: torch.Generator().manual_seed(i) for t in 'ab'})
            else:
                tstep.train_step(state, tbatch)
        return state.model.state_dict()
    plain = train(2)
    tracing.clear()
    with all_threads_profiler():
        traced = train(2)
    found = tracing.spans()
    tracing.clear()
    for k, v in plain.items():
        assert torch.equal(v, traced[k]), k
    roots = [s for s in found if s.name == 'train.step']
    assert len(roots) == 2
    for root in roots:
        kids = [s for s in found if s.parent == root.id]
        assert [s.name for s in kids] == ['train.forward', 'train.backward',
                                          'train.update']
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   and s.device_ms is None for s in kids)
