"""Training on the bfloat16 compute path: the port against eve_tpu, on the CPU.

One training step of ``configs/refine_net.json`` (frozen EyeNet) and of
``configs/eye_net.json`` at ``tpu_compute_dtype`` 'bfloat16', the cases of
``tests/test_torch_train_step.py`` (the same perturbed eve_tpu weights,
batch and injected kappas) at 48x48 eyes: at 32x32 ResNet-18's layer4 is
1x1, where the port's bfloat16 instance norm returns 0 and eve_tpu's
leaves rounding noise (``tests/test_torch_bf16.py``). eve_tpu's bfloat16
step is compiled without XLA's excess precision, as in that file.

Yardstick, as there: bfloat16 rounding is chaotic, so the port's step is
held against eve_tpu's own bfloat16-vs-float32 drift on the same inputs.

- ``full_loss``: error (port vs eve_tpu, both bfloat16) below the drift
  (eve_tpu bfloat16 vs float32); measured 0.37 (refine_net) and 0.18
  (eye_net) of it.
- Gradients (float32, reaching the float32 parameters through the casts):
  the L2 error over every trainable gradient below the drift's (measured
  0.74 and 0.46 of it), and each layer's (a module's weight and bias
  together) within 1.25 times its drift (measured up to 1.07): RefineNet's
  bfloat16 gradient is itself noise-sized in places, a layer's drift up to
  its whole norm, and port and eve_tpu draw that noise independently.
- The optimizer sees float32 only: gradients, Adam's moments, and the
  parameters after the update.

A bfloat16 run through the harness (in-memory clips, 48x48 eyes, B = 2,
T = 3) checkpoints float32 arrays and resumes from its own checkpoint
bitwise equal to the uninterrupted run, as a float32 run does.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import torch

from eve_tpu.models import eve as jeve
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert
from tests.test_torch_bf16 import jit_bf16
from tests.test_torch_train_harness import _config, _run
from tests.test_torch_train_step import CASES, _configs, initial_params
from tests.test_torch_train_step import make_batch
from tests.torch_clips import specs

EYE = 48
# Error over drift (module docstring).
LOSS_RATIO, GLOBAL_RATIO, LAYER_RATIO = 1.0, 1.0, 1.25


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _reference(jspec, params, batch, bf16):
    """eve_tpu's full_loss and gradients (port state dict names)."""
    fn = jax.value_and_grad(
        lambda p: jeve.forward(jspec, p, batch, training=True)['full_loss'])
    fn = jit_bf16(fn, params) if bf16 else jax.jit(fn)
    loss, grads = fn(params)
    return float(loss), {k: v.numpy() for k, v in convert.eve_state_dict(
        jax.tree_util.tree_map(np.asarray, grads)).items()}


@pytest.mark.parametrize('name', sorted(CASES))
def test_train_step_matches_eve_tpu(name):
    json_name, _, overrides = CASES[name]
    jspec32, _, _, _ = _configs(json_name, overrides)
    jspec16, _, _, tc = _configs(json_name, dict(
        overrides, tpu_compute_dtype='bfloat16'))
    params = initial_params(jspec32)
    batch = make_batch(1, EYE)
    loss32, grads32 = _reference(jspec32, params, batch, False)
    loss16, grads16 = _reference(jspec16, params, batch, True)

    model = teve.build_model(teve.EveSpec.from_config(tc),
                             convert.eve_state_dict(params), 'cpu')
    state = tstep.create_train_state(tc, model, 4)
    out = tstep.accumulate_gradients(model, teve.batch_to_tensors(batch,
                                                                  'cpu'))
    assert out['full_loss'].dtype == torch.float32
    loss = out['full_loss'].item()
    print('%s full_loss: port %.6f, eve_tpu bf16 %.6f, f32 %.6f, ratio %.3f'
          % (name, loss, loss16, loss32,
             abs(loss - loss16) / abs(loss16 - loss32)))
    assert abs(loss - loss16) < LOSS_RATIO * abs(loss16 - loss32)

    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert grads and {g.dtype for g in grads.values()} == {torch.float32}
    layers = {}
    for n, g in grads.items():
        err, drift = layers.setdefault(n.rsplit('.', 1)[0], [0.0, 0.0])
        layers[n.rsplit('.', 1)[0]] = [
            err + float(np.sum((g.numpy() - grads16[n]) ** 2)),
            drift + float(np.sum((grads16[n] - grads32[n]) ** 2))]
    total_err = np.sqrt(sum(e for e, _ in layers.values()))
    total_drift = np.sqrt(sum(d for _, d in layers.values()))
    assert all(e == 0.0 for e, d in layers.values() if d == 0.0)
    worst = max((np.sqrt(e / d), k) for k, (e, d) in layers.items() if d)
    print('%s gradients: L2 error / drift %.3f over all, worst layer %.3f '
          '(%s)' % (name, total_err / total_drift, *worst))
    assert total_err < GLOBAL_RATIO * total_drift
    assert worst[0] < LAYER_RATIO, worst

    state.step += 1
    tstep.apply_update(state)
    moments = [v for s in state.optimizer.state.values() for v in s.values()
               if isinstance(v, torch.Tensor) and v.ndim]
    assert moments and {m.dtype for m in moments} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_bfloat16_run_resumes_from_its_checkpoint(tmp_path):
    sets = [specs('train', 0, 8)], [specs('val', 1, 4)]
    cfg = dict(tpu_compute_dtype='bfloat16', eyes_size=[EYE, EYE])
    exp, losses = _run(_config(**cfg), str(tmp_path / 'runs'), *sets)
    assert exp.spec.dtype == torch.bfloat16
    assert sorted(losses) == [0, 1, 2, 3]
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    ckpt = os.path.join(exp.output_dir, 'checkpoints', '0000002.ckpt')
    for name in sorted(os.listdir(ckpt)):
        with np.load(os.path.join(ckpt, name)) as z:
            kinds = {z[k].dtype for k in z.files if z[k].dtype.kind == 'f'}
        assert kinds == {np.dtype(np.float32)}, (name, kinds)
    run_dir = str(tmp_path / 'resumed')
    shutil.copytree(ckpt, os.path.join(run_dir, 'checkpoints',
                                       '0000002.ckpt'))
    exp2, resumed = _run(_config(resume_from=run_dir, **cfg),
                         str(tmp_path), *sets)
    assert sorted(resumed) == [2, 3]
    for step, loss in resumed.items():
        assert torch.equal(loss, losses[step]), step
    a, b = exp.state.model.state_dict(), exp2.state.model.state_dict()
    for k, v in a.items():
        assert v.dtype == torch.float32 and torch.equal(b[k], v), k
