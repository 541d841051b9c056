"""The control of ``correct`` comes out not correct: one step below the
configuration's precision (the plain reference with float8 operands in
the program's place for bfloat16; the program's own TF32 path for
float32), it fails at least one of the cell's limits; so do training's
faults.

The bfloat16 cells on the CPU at the tiny size (TF32 exists only on the
card); every cell with the ``cuda`` marker on the card at the cells' own
sizes on three seeds (``python -m pytest benchmark/tests -m cuda`` on a
machine with a card)."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

SEEDS = (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9)


def _readings(cell, seed, device):
    with harness.float32_mode():
        kind = cell.params['kind']
        if kind == 'stream':
            return control.stream_readings(cell, seed, harness.run_seconds(),
                                           device)
        if kind == 'offline':
            return control.offline_readings(cell, seed, device)
        return control.train_readings(cell, seed, device)


def _fails_a_limit(cell, numbers):
    return any(numbers[name] > limit for name, limit in cell.limits.items())


@pytest.mark.parametrize('name', tiny.CELLS[:2])
def test_control_fails_at_the_tiny_size(name):
    torch.set_num_threads(2)
    cell = tiny.tiny_cell(name, float32=False)
    readings = _readings(cell, tiny.SEED, torch.device('cpu'))
    assert _fails_a_limit(cell, readings['control']), readings


@pytest.mark.cuda
@pytest.mark.parametrize('name', tiny.CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cell = harness.load_cell(name)
    device = torch.device('cuda', 0)
    for seed in SEEDS:
        readings = _readings(cell, seed, device)
        assert _fails_a_limit(cell, readings['control']), (seed, readings)
        if cell.params['kind'] == 'train':
            for fault in ('half_batch', 'state_unchanged'):
                assert _fails_a_limit(cell, readings[fault]), (seed, fault)
