"""``configs/eye_net.json`` at its learning rate: 6 steps of both packages.

On the card, ``configs/eye_net.json`` on seeded weights raised its
``full_loss`` from 65 to 213 over 6 steps. This holds the port's 6-step
trajectory against eve_tpu's, on the CPU, from the same weights (eve_tpu's
``init_params``, seed 0, unperturbed: the config's own start), six
synthetic batches and injected kappas, at the config's learning rate of
0.016 (``base_learning_rate`` set so that ``batch_size`` times it is
0.016 at the small batch; one epoch is the 6 updates, so the exponential
decay does not start).

Sizes: 64x64 eyes, B = 2, T = 3. Tolerance: each step's ``full_loss``
within rtol 1e-2 of eve_tpu's (measured 1.6e-3, at step 4): Adam moves
every element by about the LR of 0.016 an update whatever its gradient's
size, so an element whose gradient lies within float32 rounding of 0
steps either way in the two frameworks, and the next losses follow.

Both rise the same way (measured 45 -> 217), so the rise belongs to the
config at this LR, not to the port. By hand, at full width::

    python -m tests.test_torch_eye_net_trajectory --eyes 128 --batch 16

(from the repository root; prints both trajectories.)
"""

import argparse
import functools
import os

import numpy as np

import jax
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.models import eve as jeve
from eve_tpu.train import optim as joptim
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.train import step as tstep
from eve_tpu_torch.utils import convert
from tests.test_torch_train_step import make_batch

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'eye_net.json')
STEPS, LR, T = 6, 0.016, 3


def trajectories(eyes, batch_size):
    """``(eve_tpu's, the port's)`` full_loss of each of the STEPS steps."""
    overrides = {'batch_size': batch_size,
                 'base_learning_rate': LR / batch_size,
                 'max_sequence_len': T}
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        jc.import_dict(overrides)
        jspec = jeve.EveSpec.from_config(jc)
        tx, _ = joptim.build_optimizer(jc, STEPS)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict(overrides)
    assert abs(tc.learning_rate - LR) < 1e-9

    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        functools.partial(jeve.init_params, jspec))(jax.random.PRNGKey(0)))
    batches = [make_batch(100 + i, eyes, batch_size=batch_size)
               for i in range(STEPS)]
    assert batches[0]['left_eye_patch'].shape[1] == T

    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jeve.forward(
        jspec, p, b, training=True)['full_loss']))

    @jax.jit
    def update(p, opt_state, grads):
        upd, opt_state = tx.update(grads, opt_state, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), opt_state

    theirs, p, opt_state = [], params, tx.init(params)
    for batch in batches:
        loss, grads = grad_fn(p, batch)
        theirs.append(float(loss))
        p, opt_state = update(p, opt_state, grads)

    model = teve.build_model(teve.EveSpec.from_config(tc),
                             convert.eve_state_dict(params), 'cpu')
    state = tstep.create_train_state(tc, model, STEPS)
    ours = [float(tstep.train_step(
        state, teve.batch_to_tensors(batch, 'cpu'))['full_loss'])
        for batch in batches]
    return theirs, ours


def test_eye_net_trajectory_matches_eve_tpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        theirs, ours = trajectories(64, 2)
    finally:
        torch.set_num_threads(threads)
    print('eve_tpu %s\nport    %s' % (theirs, ours))
    np.testing.assert_allclose(ours, theirs, rtol=1e-2)
    assert theirs[-1] > 3 * theirs[0]   # the rise the card showed


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--eyes', type=int, default=128)
    parser.add_argument('--batch', type=int, default=2)
    args = parser.parse_args()
    jax.config.update('jax_platforms', 'cpu')
    theirs, ours = trajectories(args.eyes, args.batch)
    print('eyes %d, B = %d, T = %d, LR %g' % (args.eyes, args.batch, T, LR))
    print('eve_tpu full_loss: %s' % ', '.join('%.4f' % x for x in theirs))
    print('port full_loss:    %s' % ', '.join('%.4f' % x for x in ours))
    print('relative difference: %s' % ', '.join(
        '%.2e' % (abs(a - b) / abs(a)) for a, b in zip(theirs, ours)))
