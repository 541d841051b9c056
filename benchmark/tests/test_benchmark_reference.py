"""The plain reference against the measured program at small sizes on the
CPU, both in float32: the forward of both configurations, a session
streamed through the serving engine in chunks against one whole clip,
and one EyeNet training step's loss and update."""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness, synthetic, weights as weights_lib
from benchmark.reference import eve as ref, train as ref_train
from benchmark.tests.tiny import tiny_cell

# float32 on both sides: what is left is the order of summation.
PX_TOL = 0.05
REL_TOL = 1e-4


def _setup(cell_name, seed=3):
    torch.set_num_threads(2)
    cell = tiny_cell(cell_name)
    cfg = dict(cell.config['config'], tpu_compute_dtype='float32')
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, 'cpu',
                                       cell.config['weights'])
    return cell, cfg, weights


def _program(cfg, weights):
    from eve_tpu_torch.models import eve as eve_lib
    spec = eve_lib.EveSpec.from_config(harness.port_config(cfg))
    return eve_lib.build_model(spec, weights, 'cpu')


def _clips(B, T, eyes, seed=4, with_gt=False, with_screen=True):
    return synthetic.make_synthetic_batch(
        synthetic.rng_for(seed, 0), B, T, eyes, with_gt=with_gt,
        with_screen=with_screen,
        frame_generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize('cell_name', ['eve-refine-bf16.offline',
                                       'eyenet-f32.train'])
def test_forward_matches_program(cell_name):
    _, cfg, weights = _setup(cell_name)
    batch = _clips(2, 3, 64, with_screen=cfg.get('load_screen_content',
                                                  False))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = _program(cfg, weights)(tensors, output_predictions=True)
        want = ref.forward(weights, cfg, tensors)
    keys = ['PoG_px_initial', 'left_pupil_size', 'right_pupil_size']
    if cfg.get('refine_net_enabled'):
        keys.append('PoG_px_final')
    for k in keys:
        diff = (got[k] - want[k]).abs().max().item()
        scale = want[k].abs().mean().item()
        tol = PX_TOL if k.startswith('PoG') else REL_TOL * scale
        assert diff <= tol, (k, diff, tol)
    # The PoGs lie on the screen, not clamped at its edges.
    pog = want['PoG_px_initial']
    assert ((pog > 0) & (pog < torch.tensor([1920.0, 1080.0]))).all()


def test_session_in_chunks_matches_whole_clip():
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.serve import ServingEngine
    _, cfg, weights = _setup('eve-refine-bf16.stream')
    spec = eve_lib.EveSpec.from_config(harness.port_config(cfg))
    clip = _clips(1, 6, 64)
    engine = ServingEngine(spec, weights, device='cpu', max_batch=2,
                           max_delay_ms=1.0)
    try:
        sid = engine.open_session()
        served = [engine.infer({k: v[0, a:a + 2] for k, v in clip.items()},
                               sid, timeout=120) for a in (0, 2, 4)]
    finally:
        engine.stop()
    with torch.no_grad():
        want = ref.forward(weights, cfg,
                           {k: torch.from_numpy(v) for k, v in clip.items()})
    for k in ('PoG_px_initial', 'PoG_px_final'):
        got = np.concatenate([s[k] for s in served])
        diff = np.abs(got - want[k][0].numpy()).max()
        assert diff <= PX_TOL, (k, diff)


def test_train_step_matches_program():
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import step as step_lib
    from benchmark.traffic import train
    _, cfg, weights = _setup('eyenet-f32.train')
    config = harness.port_config(cfg)
    model = eve_lib.build_model(eve_lib.EveSpec.from_config(config),
                                copy.deepcopy(weights), 'cpu')
    state = step_lib.create_train_state(config, model, 1000)
    batch = _clips(2, 3, 64, with_gt=True, with_screen=False)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = step_lib.train_step(state, tensors, torch.Generator().manual_seed(0))
    names = {id(p): k for k, p in model.named_parameters()}
    program = {
        'losses': [float(out['full_loss'])],
        'first_grads': {names[id(p)]: s['exp_avg'] / (1.0 - ref_train.BETA1)
                        for p, s in state.optimizer.state.items()},
        'change': {k: p.detach() - weights[k]
                   for k, p in model.named_parameters()}}
    reference = ref_train.run_steps(
        weights, [tensors], lambda w, b: ref.eye_net_loss(w, cfg, b),
        lr=cfg['batch_size'] * cfg['base_learning_rate'],
        weight_decay=cfg['weight_decay'],
        clip_amount=cfg['gradient_clip_amount'])
    losses, first, raw, final = reference
    change = {k: final[k] - weights[k] for k in final}
    numbers = {name: value for name, (value, _) in train.gaps(
        program, (losses, first, raw, change),
        train.moving_leaves(raw)).items()}
    # float32 on both sides. The change is compared by its norm a leaf:
    # where a gradient element is all but zero, Adam's step flips sign on
    # rounding alone.
    for name, value in numbers.items():
        assert value <= REL_TOL, (name, value)
