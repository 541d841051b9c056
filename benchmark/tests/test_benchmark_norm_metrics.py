"""The norm kernel's per-layer readers on synthetic stretches: its ms and
launches a batch, 0 from a stretch without the kernel where the program has
it, and nothing where the program has no such kernel."""

import builtins

import pytest

from benchmark import harness
from benchmark.trace import Stretch

MS = 'kernels.instance_norm_ms.offline'
LAUNCHES = 'kernels.instance_norm_launches.offline'


def _record(device, units=2):
    return {'stretch': Stretch(0.0, 1.0, device, []), 'stretch_units': units}


def test_norm_readers_sum_the_kernel_a_batch():
    rec = _record([
        ('void (anonymous namespace)::instance_norm_kernel_block<4>(...)',
         0.0, 0.003),
        ('void (anonymous namespace)::instance_norm_kernel_group<2>(...)',
         0.1, 0.101),
        ('void at::native::reduce_kernel<512, 1>(...)', 0.2, 0.25),
        ('Memcpy HtoD (Pageable -> Device)', 0.3, 0.4)])
    assert harness.reader(MS)(rec) == pytest.approx(2.0)
    assert harness.reader(LAUNCHES)(rec) == 1.0


@pytest.mark.parametrize('name', [MS, LAUNCHES])
def test_norm_readers_read_0_where_the_kernel_did_not_run(name):
    """The program has the kernel but the stretch holds no launch of it
    (the norms left the kernel): 0, not nothing."""
    rec = _record([('void at::native::reduce_kernel<512, 1>(...)', 0.0,
                    0.5)])
    assert harness.reader(name)(rec) == 0.0
    assert harness.reader(name)({'stretch': None}) is None


@pytest.mark.parametrize('name', [MS, LAUNCHES])
def test_norm_readers_read_nothing_without_the_kernels_module(name,
                                                              monkeypatch):
    """A program without ``eve_tpu_torch.kernels.norm_kernels`` (a commit
    before the kernel) reads nothing."""
    real = builtins.__import__

    def refuse(module, *args, **kwargs):
        if module == 'eve_tpu_torch.kernels.norm_kernels':
            raise ImportError(module)
        return real(module, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', refuse)
    rec = _record([('void (anonymous namespace)::instance_norm_kernel_'
                    'group<2>(...)', 0.0, 0.001)])
    assert harness.reader(name)(rec) is None
