"""Training steps through ``train.step.create_train_state`` and
``train_step``: the first stage of EVE training (EyeNet).

Labelled clips of the configuration's ``batch_size`` x
``max_sequence_len`` frames (its eye size, its frame rate), uint8 on the
host, are copied to the card each step (``batch_to_tensors``) and trained
on with the configuration's losses, clip and Adam; ``distinct_batches``
seeded batches are cycled. Set-up builds one train state and drives it
from the seed through its first ``warmup_steps`` steps, which go through
the window's own feed and call on batches whose rows all differ; the same
state then trains through the window. The window runs whole steps until
``--seconds`` have passed; the rate is every frame of those steps over
the time they took.

``correct``: the reference follows the first three steps from the same
weights and batches. Compared: the first step's loss, the first gradient
as Adam took it (read from its first moment after one step) by the worst
leaf, and the parameters' change over the three steps, as the fourth
step found them, by the worst and by the median leaf (the worst leaves
are named beside the numbers).
"""

import time

import numpy as np
import torch

from benchmark import compare, harness, synthetic, weights as weights_lib
from benchmark.reference import eve as ref, train as ref_train

CHECKED_STEPS = 3


def make_batches(cell, seed):
    B, T, eyes, fps = harness.shapes(cell.config['config'])
    rng = synthetic.rng_for(seed, 1)
    return [synthetic.make_synthetic_batch(
        rng, B, T, eyes, with_screen=False, with_gt=True, fps=fps)
        for _ in range(cell.params['distinct_batches'])]


def _snapshot(named):
    return {k: p.detach().clone() for k, p in named.items()}


class Program:
    """The program's train state on ``weights``, driven from the seed
    through its first ``warmup_steps`` steps on ``batches`` by the
    window's own feed and call (``step``). ``first`` holds what the check
    reads of the first ``CHECKED_STEPS``: each step's loss, the first
    gradient as Adam took it (its first moment after one step) and the
    parameters' change over the steps."""

    def __init__(self, cell, seed, weights, batches, device):
        from eve_tpu_torch.models import eve as eve_lib
        from eve_tpu_torch.train import step as step_lib
        from eve_tpu_torch.utils.tensors import batch_to_tensors
        self._step, self._feed = step_lib.train_step, batch_to_tensors
        self.batches, self.device = batches, device
        config = harness.port_config(cell.config['config'])
        self.model = eve_lib.build_model(eve_lib.EveSpec.from_config(config),
                                         weights, device)
        self.state = step_lib.create_train_state(
            config, self.model, cell.params['updates_per_epoch'])
        self.kappas = torch.Generator().manual_seed(int(seed) % (2 ** 63))
        trained = {k: v for k, v in self.model.named_parameters()
                   if v.requires_grad}
        by_id = {id(v): k for k, v in trained.items()}
        start = _snapshot(trained)
        losses, first_grads = [], None
        for i in range(cell.params['warmup_steps']):
            losses.append(self.step(i)['full_loss'].detach())
            if i == 0:
                first_grads = {
                    by_id[id(v)]: (s['exp_avg']
                                   / (1.0 - ref_train.BETA1)).clone()
                    for v, s in self.state.optimizer.state.items()}
            if i + 1 == CHECKED_STEPS:
                after = _snapshot(trained)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.first = {'losses': [float(x) for x in losses[:CHECKED_STEPS]],
                      'first_grads': first_grads,
                      'change': {k: after[k] - start[k] for k in after}}

    def step(self, i):
        return self._step(self.state, self._feed(
            self.batches[i % len(self.batches)], self.device), self.kappas)

    def release(self):
        self.state = self.model = None


def run(cell, seed, seconds, trace, device, start):
    p = cell.params
    cfg = cell.config['config']
    B, T, eyes, _ = harness.shapes(cfg)
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, device,
                                       cell.config['weights'])
    batches = make_batches(cell, seed)
    program = Program(cell, seed, weights, batches, device)
    frames = B * T

    tracer = None
    if trace:
        from benchmark.trace import Tracer
        tracer = Tracer(device)
    first, last = p['trace_steps']
    steps = 0
    t0 = time.perf_counter()
    setup_s = t0 - start
    while True:
        if tracer is not None and steps == first:
            tracer.start()
        program.step(p['warmup_steps'] + steps)
        steps += 1
        if tracer is not None and steps == last:
            tracer.stop()
        if time.perf_counter() - t0 >= seconds and steps >= last:
            break
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    record = {
        'setup_s': setup_s, 'window_s': window_s,
        'on_card': device.type == 'cuda', 'units': steps,
        'frames': steps * frames,
        'stretch': tracer.read() if tracer else None,
        'stretch_units': last - first,
        'flops_per_unit': None,
        'peak_flops_dtype': cfg.get('tpu_compute_dtype', 'float32'),
    }
    if trace:
        from benchmark.reference import flops
        record['flops_per_unit'] = flops.train_step(cfg, B, T, eyes)
    harness.note('train: %d steps of %d frames in %.3f s'
                 % (steps, frames, window_s))

    def release():
        program.release()
        if device.type == 'cuda':
            torch.cuda.empty_cache()

    def check():
        return check_steps(cell, weights, batches, program.first, device)

    return harness.Run(record=record, attempted=steps, failed=0,
                       release=release, check=check)


def reference_steps(cfg, weights, batches, device):
    """The reference's first ``CHECKED_STEPS`` steps: ``(losses, first
    gradients as Adam takes them, raw first gradients, change)``."""
    tensors = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in batches[:CHECKED_STEPS]]
    losses, first, raw, final = ref_train.run_steps(
        weights, tensors, lambda w, b: ref.eye_net_loss(w, cfg, b),
        lr=cfg['batch_size'] * cfg['base_learning_rate'],
        weight_decay=cfg['weight_decay'],
        clip_amount=cfg['gradient_clip_amount'])
    change = {k: final[k] - weights[k] for k in final}
    return losses, first, raw, change


def loss_gaps(program, reference):
    """Each step's relative gap between the program's loss and the
    reference's."""
    return [abs(a - b) / abs(b) for a, b in zip(program['losses'],
                                                 reference[0])]


def gaps(program, reference, moving):
    """The numbers compared, ``{name: (value, worst leaf)}``: the first
    step's loss (later steps' losses move with Adam's sign flips on
    gradient elements that are zero to rounding; they are printed beside
    it), the first gradient by the worst leaf, and the change by the
    worst and by the median leaf. ``moving``: the leaves whose parameter
    change counts.

    The worst leaf's change swings from seed to seed by its nature: Adam's
    first step moves each element by about the learning rate in the
    direction of its gradient's sign, the two sides round the few
    elements whose gradient is zero to rounding differently, and where
    such a flip tips a unit of a small leaf (the pupil head, the GRU's
    input) across its ReLU's edge, the next steps move the leaf apart.
    The median leaf's change is steady, and parts float32 from TF32."""
    _, first, _, want_change = reference

    def norms(tree, keys):
        # A leaf the program never gave (no Adam state) reads 0.
        return {k: float(tree[k].norm()) if k in tree else 0.0
                for k in keys}
    grad = compare.leaf_gap(norms(program['first_grads'], first),
                            norms(first, first))
    change = compare.leaf_gaps(norms(program['change'], moving),
                               norms(want_change, moving))
    worst = max(change, key=change.get)
    return {
        'loss_rel': (loss_gaps(program, reference)[0], None),
        'grad_norm_gap': grad,
        'change_norm_gap': (change[worst], worst),
        'change_gap_median_leaf': (
            float(np.median(list(change.values()))), None)}


def sign_flips(program, reference):
    """Elements that Adam's first step moved the other way in the program
    than in the reference (the step is about the learning rate times the
    sign of the first gradient as Adam took it, whatever its size): the
    count over every leaf and the leaf with the most."""
    first, given = reference[1], program['first_grads']
    # A leaf the program never gave (no Adam state) did not move at all.
    flips = {k: int((torch.sign(given[k]) != torch.sign(g)).sum())
             if k in given else int(g.numel()) for k, g in first.items()}
    most = max(flips, key=flips.get)
    return {'elements': sum(flips.values()),
            'of': sum(int(v.numel()) for v in first.values()),
            'most_in': most, 'there': flips[most]}


def moving_leaves(raw_first):
    """Leaves whose change counts: a leaf whose first gradient is below a
    thousandth of the median leaf's moves under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in raw_first.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= floor]


def check_steps(cell, weights, batches, program, device):
    with harness.float32_mode():
        reference = reference_steps(cell.config['config'], weights,
                                    batches, device)
        moving = moving_leaves(reference[2])
        found = gaps(program, reference, moving)
        info = {'loss_rel_each_step': loss_gaps(program, reference),
                'worst_leaf': {name: leaf for name, (_, leaf) in
                               found.items() if leaf is not None},
                'first_step_sign_flips': sign_flips(program, reference),
                'leaves_left_out': sorted(set(reference[2]) - set(moving))}
        return [(name, value, cell.limits[name]) for name, (value, _) in
                found.items()], info
