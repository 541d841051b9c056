"""Runs with the timed path broken underneath come out not correct.

Each test drives the rest of a run at the tiny CPU size (past the look
for a card) with one fault planted in the program, once for each fault
the cell can have: an answer altered where it is produced (serving and
evaluation), a step that returns its state unchanged and half of each
batch left out, the mean taken over the rest (training). One chip, so no
exchange between chips to leave out."""

import pytest

from benchmark.tests import tiny


def _altered_answers(monkeypatch):
    """Every forward's refined point of gaze moved by 300 px."""
    from eve_tpu_torch.models import eve as eve_lib
    forward = eve_lib.EVE.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out['PoG_px_final'] = out['PoG_px_final'] + 300.0
        return out
    monkeypatch.setattr(eve_lib.EVE, 'forward', altered)


@pytest.mark.parametrize('cell', ['eve-refine-bf16.stream',
                                  'eve-refine-bf16.offline'])
def test_altered_answer_is_not_correct(cell, monkeypatch):
    assert tiny.measure(cell)['correct']
    _altered_answers(monkeypatch)
    result = tiny.measure(cell)
    assert not result['correct']
    check = result['checks']['pog_final_nmse']
    assert check['value'] > check['limit']


def test_unchanged_state_is_not_correct(monkeypatch):
    from eve_tpu_torch.train import step as step_lib

    def no_update(state):
        state.optimizer.zero_grad(set_to_none=True)
    monkeypatch.setattr(step_lib, 'apply_update', no_update)
    result = tiny.measure('eyenet-f32.train')
    assert not result['correct']
    assert result['checks']['change_norm_gap']['value'] == pytest.approx(1.0)


def test_half_batch_is_not_correct(monkeypatch):
    from eve_tpu_torch.train import step as step_lib
    accumulate = step_lib.accumulate_gradients

    def half(model, batch, generator=None, seq=None):
        rows = batch['left_eye_patch'].shape[0] // 2
        return accumulate(model, {k: v[:rows] for k, v in batch.items()},
                          generator, seq)
    monkeypatch.setattr(step_lib, 'accumulate_gradients', half)
    assert not tiny.measure('eyenet-f32.train')['correct']
