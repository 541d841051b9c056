"""The port writes eve_tpu's optimizer file, ``optimizer_0.npz``.

The mirror of ``tests/test_torch_train_moments.py``, which holds the
other direction. On the full-width model's parameter tree:

- For seven chain layouts (that file's five, a frozen EyeNet with an LR
  multiplier, whose clip is masked off the EyeNet, and a state stopped
  mid-accumulation), the flat keys, dtypes and shapes of
  ``optax_state_flat`` equal eve_tpu's ``flatten_tree(build_optimizer(
  ...).init(params))``; every ``count`` and ``gradient_step`` is the
  number of updates taken, ``mini_step`` the micro-steps into the next,
  and the file read back through ``optax_optimizer_tree`` gives the
  port's optimizer state bitwise.
- eve_tpu's own ``CheckpointManager.load`` reads the port's checkpoint
  after 3 port micro-steps; eve_tpu and the port then take the same 3
  more on the same fixed gradients, and the parameters agree within that
  file's trajectory tolerance: rtol 2e-5 + 1e-5 per update, atol 3e-7 x
  (1 + update). eve_tpu resuming with a fresh optimizer instead misses it.
"""

import os

import numpy as np
import pytest

import jax

from eve_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from eve_tpu.train.checkpoint import flatten_tree as jflatten
from eve_tpu.train.step import TrainState as JaxTrainState
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.utils import convert
from tests import test_torch_train_moments as tm
# The moments file's fixtures: the seeded tree, its gradients, 2 threads.
from tests.test_torch_train_moments import (  # noqa: F401
    _few_threads, gradients, initial_tree)

# (config, overrides, micro-steps before the file is written). Weight
# decay stays as each config sets it (eye_net.json 0.005), so the decay
# node is laid out too.
STRUCTURE = dict(
    {name: (json_name, extra, 2)
     for name, (json_name, extra) in tm.LAYOUTS.items()},
    **{'frozen-eye-lr': ('refine_net.json', {
        'refine_net_learning_rate_multiplier': 2.0}, 2),
       'mid-accumulation': ('eye_net.json', {
           'gradient_accumulation_steps': 2}, 3)})
BASE = {k: v for k, v in tm.BASE.items() if k != 'weight_decay'}


def _port_after(json_name, overrides, initial_tree, gradients, steps):
    """eve_tpu's chain, the port's state after ``steps`` micro-steps, and
    the parameter tree both start from."""
    tx, tc = tm._configs(json_name, overrides)
    subs = ['eye_net'] + (['refine_net'] if tc.refine_net_enabled else [])
    tree = {k: initial_tree[k] for k in subs}
    state = tm._port_state(tc, tree)
    tm._port_steps(state, gradients[1][:steps])
    return tx, tree, state


@pytest.mark.parametrize('layout', sorted(STRUCTURE))
def test_written_tree_is_eve_tpus(layout, initial_tree, gradients):
    json_name, extra, steps = STRUCTURE[layout]
    tx, tree, state = _port_after(json_name, dict(BASE, **extra),
                                  initial_tree, gradients, steps)
    ours = tckpt.optax_state_flat(state)
    theirs = jflatten(tx.init(tree))
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert (ours[k].dtype, ours[k].shape) == (v.dtype, v.shape), k
    counts = {k: int(v) for k, v in ours.items()
              if k.rsplit('/', 1)[-1] in ('count', 'gradient_step')}
    assert counts and set(counts.values()) == {state.updates}
    mini_step = state.step % state.accumulation_steps
    assert int(ours.get('mini_step', 0)) == mini_step
    assert (layout == 'mid-accumulation') == (mini_step == 1)
    # Read back, the file is the port's optimizer state, bitwise.
    back = tckpt.optax_optimizer_tree(state, ours)
    _, opt = tckpt.snapshot(state)
    want = tckpt.unflatten_tree({k: v.numpy() for k, v in opt.items()})
    assert back['state'].keys() == want['state'].keys()
    for name, values in want['state'].items():
        for k, v in values.items():
            np.testing.assert_array_equal(back['state'][name][k], v,
                                          err_msg=name + k)
    assert back['grad'].keys() == want.get('grad', {}).keys()
    for name, g in back['grad'].items():
        np.testing.assert_array_equal(g, want['grad'][name], err_msg=name)


@pytest.mark.parametrize('layout', sorted(tm.LAYOUTS) + ['frozen-eye-lr'])
def test_eve_tpu_continues_the_ports_run(layout, initial_tree, gradients,
                                         tmp_path):
    json_name, extra, _ = STRUCTURE[layout]
    before, after = tm.BEFORE, tm.AFTER
    tx, tree, state = _port_after(json_name, dict(tm.BASE, **extra),
                                  initial_tree, gradients, before)
    run = str(tmp_path / 'run')
    path = tckpt.CheckpointManager(run).save_at_step(before, state)
    assert tckpt.OPTAX_OPTIMIZER_FILE in os.listdir(path)
    tm._port_steps(state, gradients[1][before:])
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    trees = [{k: t[k] for k in tree} for t in gradients[0]]

    def eve_tpu_resumed(load_optimizer):
        template = JaxTrainState(step=np.int32(0), params=tree,
                                 opt_state=tx.init(tree))
        loaded, step = JaxCheckpoints(run).load_last_checkpoint(
            template, load_optimizer=load_optimizer)
        assert step == before
        params, _ = tm._eve_tpu_steps(tx, loaded.params, loaded.opt_state,
                                      trees[before:])
        return {k: v.numpy() for k, v in convert.eve_state_dict(
            jax.tree_util.tree_map(np.asarray, params)).items()}

    want = eve_tpu_resumed(True)
    update = before + after
    tol = dict(rtol=2e-5 + 1e-5 * update, atol=3e-7 * (1 + update))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
    if layout == 'flat':
        fresh = eve_tpu_resumed(False)
        assert any(not np.allclose(fresh[k], v, **tol)
                   for k, v in got.items())
