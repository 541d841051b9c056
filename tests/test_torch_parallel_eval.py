"""``infer.iterator(mesh=)`` and ``cli.eval_codalab._eval_mesh`` of the port
against eve_tpu's, on the CPU.

Ten labelled clips (T = 4, 32x32 eyes, the ``configs/refine_net.json``
model with every parameter perturbed) go through each package's iterator
at batch size 4, so the last batch is ragged (2 clips), over a data mesh
of 2 and 4 devices: the port's of CPU replicas, eve_tpu's of virtual CPU
devices. Every per-clip output and every 0-dim output (the losses, a
mean over the padded batch in both packages) agrees within
``tests/test_torch_infer.py``'s tolerances (PoG px rtol 1e-4 + atol 1e-2
px, everything else rtol 1e-4 + atol 1e-4); the int64 stamps exactly
(eve_tpu's stamps of the ragged batch keep its padded rows; the port's
are cut to the real clips, as its other outputs are). The
three ``ValueError``s of eve_tpu's mesh iterator, and ``_eval_mesh``'s
device-count rule over a grid of batch sizes and device counts, are held
to eve_tpu's.
"""

import functools
import logging
import os
import types

import numpy as np
import pytest

import jax
import torch

from eve_tpu import infer as jinfer
from eve_tpu.cli import eval_codalab as jeval
from eve_tpu.config import DefaultConfig
from eve_tpu.data.loader import DataLoader as JDataLoader
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import eve as jeve
from eve_tpu.parallel import mesh as jmesh
from eve_tpu_torch import config as tconfig
from eve_tpu_torch import infer
from eve_tpu_torch.cli import eval_codalab
from eve_tpu_torch.data.loader import DataLoader
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.parallel import mesh as tmesh
from eve_tpu_torch.utils import convert

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
EYE, T, CLIPS, BATCH = 32, 4, 10, 4


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tolerance(key):
    if 'PoG_px' in key:
        return dict(rtol=1e-4, atol=1e-2)
    return dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope='module')
def specs():
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        jc.import_dict({'eyes_size': [EYE, EYE]})
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict({'eyes_size': [EYE, EYE]})
    return jspec, teve.EveSpec.from_config(tc)


@pytest.fixture(scope='module')
def params(specs):
    tree = jax.jit(functools.partial(jeve.init_params, specs[0]))(
        jax.random.PRNGKey(3))
    tree = _perturb(tree, np.random.RandomState(3))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


@pytest.fixture(scope='module')
def model(specs, params):
    return teve.build_model(specs[1], convert.eve_state_dict(params), 'cpu')


class _Clips:
    """Labelled clips with the reader's string keys and int64 stamps."""

    def __init__(self):
        batch = make_synthetic_batch(np.random.RandomState(7),
                                     batch_size=CLIPS, sequence_len=T,
                                     eyes_size=EYE, frame_dtype=np.uint8)
        batch['timestamps'] = (int(1.6e18) + np.arange(T) * 33333333 +
                               1000 * np.arange(CLIPS)[:, None]).astype(
                                   np.int64)
        self.clips = [dict({k: v[i] for k, v in batch.items()},
                           participant='test01', subfolder='step%03d' % i,
                           camera='webcam_c') for i in range(CLIPS)]

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def _run(iterator):
    return [outputs for _, _, outputs in iterator]


@pytest.mark.parametrize('n', [2, 4])
def test_mesh_iterator_matches_eve_tpus(specs, params, model, n):
    clips = _Clips()
    ref = _run(jinfer.iterator(
        specs[0], params, JDataLoader(clips, batch_size=BATCH,
                                      num_workers=0),
        create_images=False, materialize_inputs=False,
        mesh=jmesh.make_mesh(n)))
    ours = _run(infer.iterator(
        model, DataLoader(clips, batch_size=BATCH, num_workers=0),
        create_images=False, materialize_inputs=False,
        mesh=tmesh.make_mesh(devices=['cpu'] * n)))
    assert [o['PoG_px_final'].shape[0] for o in ours] == [4, 4, 2]
    for b, (got, want) in enumerate(zip(ours, ref)):
        assert set(got) == set(want), b
        # eve_tpu's stamps of a ragged batch keep the padded rows (its
        # host extras come from the padded batch); the real rows agree.
        rows = got['PoG_px_final'].shape[0]
        np.testing.assert_array_equal(got['timestamps'],
                                      want['timestamps'][:rows])
        scalars = [k for k in want if np.ndim(want[k]) == 0]
        assert 'full_loss' in scalars
        for k in sorted(set(want) - {'timestamps'}):
            np.testing.assert_allclose(
                np.asarray(got[k], np.float64),
                np.asarray(want[k], np.float64)[:rows] if np.ndim(want[k])
                else np.float64(want[k]),
                err_msg='batch %d %s' % (b, k), **_tolerance(k))


def test_mesh_iterator_matches_one_device(model):
    """The 2-replica iterator gives the one-device iterator's per-clip
    outputs: the ragged batch is padded and cut."""
    clips = _Clips()
    one = _run(infer.iterator(
        model, DataLoader(clips, batch_size=BATCH, num_workers=0),
        create_images=False))
    two = _run(infer.iterator(
        model, DataLoader(clips, batch_size=BATCH, num_workers=0),
        create_images=False, mesh=2))
    for got, want in zip(two, one):
        for k in ('PoG_px_initial', 'PoG_px_final', 'left_pupil_size'):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **_tolerance(k))


def test_mesh_iterator_value_errors(model, specs, params):
    """eve_tpu's three refusals, in both packages."""
    clips = _Clips()
    for package, args, mesh in (
            (infer, (model,), tmesh.make_mesh(devices=['cpu'] * 2)),
            (jinfer, specs[:1] + (params,), jmesh.make_mesh(2))):
        loader_cls = DataLoader if package is infer else JDataLoader
        with pytest.raises(ValueError, match='streaming'):
            next(package.iterator(*args, loader_cls(
                clips, batch_size=1, num_workers=0), streaming=True,
                mesh=mesh))
        with pytest.raises(ValueError, match='batch_size attribute'):
            next(package.iterator(*args, [clips[0]], mesh=mesh))
        with pytest.raises(ValueError, match='must divide by the 2-device'):
            next(package.iterator(*args, loader_cls(
                clips, batch_size=3, num_workers=0), mesh=mesh))


def test_eval_mesh_rule_matches_eve_tpus(caplog):
    """The device count ``_eval_mesh`` takes for each (devices asked for,
    batch size), and its warning, against eve_tpu's (8 virtual devices)."""
    for devices in range(1, 9):
        for batch in (1, 2, 3, 4, 6, 7, 8, 12, 128):
            config = types.SimpleNamespace(tpu_num_devices=devices)
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                want = jeval._eval_mesh(config, batch)
            warned = 'not divisible' in caplog.text
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                got = eval_codalab._eval_mesh(config, batch, device='cpu')
            assert ('not divisible' in caplog.text) == warned
            want_n = 1 if want is None else want.devices.size
            got_n = 1 if got is None else got.size
            assert got_n == want_n, (devices, batch)
            if got is not None:
                assert got.devices == (torch.device('cpu'),) * got_n
