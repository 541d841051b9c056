"""The port's input-pipeline tool (``eve_tpu_torch.bench.pipeline``) against
eve_tpu's ``bench_pipeline.py``, on the CPU.

On a tiny dataset written by the tool itself with the port's writer
(eyes 32, ``--steps 2``, workers 0 and 1): the lines carry eve_tpu's
metric names and keys, with and without ``--frame-cache``; the first
batch through the tool's loader and the port's ``DevicePrefetcher``
equals the first through eve_tpu's loader and prefetcher under
``tpu_on_device_preprocess=True``; without ``cv2`` or ``h5py`` the tool
raises naming them.
"""

import argparse
import contextlib
import io
import json
import sys

import numpy as np
import pytest

from eve_tpu.config import DefaultConfig
from eve_tpu.data import dataset as jdataset
from eve_tpu.data import loader as jloader
from eve_tpu_torch.bench import pipeline
from eve_tpu_torch.data.loader import DevicePrefetcher

EYES = 32
TINY = ['--device', 'cpu', '--eyes', str(EYES), '--steps', '2',
        '--workers', '0', '1']


def run_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pipeline.main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.fixture(scope='module')
def datasrc(tmp_path_factory):
    """The dataset the tool writes, and the tool's plain run's lines."""
    root = tmp_path_factory.mktemp('pipeline')
    datasrc = str(root / 'data')
    return datasrc, run_main(TINY + ['--datasrc', datasrc])


def _check_lines(lines, metric):
    ceiling = lines[0]
    assert ceiling['metric'] == 'pipeline_compute_ceiling_fps'
    assert set(ceiling) == {'metric', 'value', 'unit', 'card'}
    assert ceiling['unit'] == 'frames/s' and ceiling['value'] > 0
    assert [line['workers'] for line in lines[1:]] == [0, 1]
    for line in lines[1:]:
        assert set(line) == {'metric', 'workers', 'value', 'unit',
                             'pct_of_ceiling', 'card'}
        assert line['metric'] == metric and line['unit'] == 'frames/s'
        assert line['value'] > 0 and line['card'] == 'cpu'
        # From the unrounded rates: the rounded ones differ by rounding.
        assert line['pct_of_ceiling'] == pytest.approx(
            100.0 * line['value'] / ceiling['value'], rel=0.02, abs=0.2)


def test_lines_are_eve_tpus(datasrc):
    _check_lines(datasrc[1], 'pipeline_end_to_end_fps')


def test_warm_cache_lines_are_eve_tpus(datasrc, tmp_path, capsys):
    lines = run_main(TINY + ['--datasrc', datasrc[0], '--frame-cache',
                             str(tmp_path / 'frames'), '--uint8'])
    _check_lines(lines, 'pipeline_end_to_end_fps_warm_cache')
    assert 'always emits uint8' in capsys.readouterr().err


def test_first_batch_is_eve_tpus(datasrc):
    args = argparse.Namespace(
        datasrc=datasrc[0], batch=4, seq=6, eyes=EYES, frame_cache='')
    ours, extras = next(iter(DevicePrefetcher(
        pipeline.make_loader(args, pipeline.pipeline_config(args), 0),
        'cpu')))

    DefaultConfig._reset_instance_for_testing()
    try:
        cfg = DefaultConfig()
        cfg.import_dict({
            'datasrc_eve': datasrc[0], 'max_sequence_len': 6,
            'assumed_frame_rate': 10, 'eyes_size': [EYES, EYES],
            'load_screen_content': False, 'refine_net_enabled': False,
            'tpu_on_device_preprocess': True, 'frame_cache_dir': ''})
        ds = jdataset.EVESequencesBase(
            datasrc[0], config=cfg, participants_to_use=['train01',
                                                         'train02'],
            cameras_to_use=['webcam_c'], types_of_stimuli=['image'],
            cache_dir=datasrc[0] + '/.segcache')
        loader = jloader.DataLoader(ds, batch_size=4, shuffle=True,
                                    drop_last=True, num_workers=0, seed=0)
        want, want_extras = next(iter(jloader.DevicePrefetcher(
            loader, lambda b: b)))
    finally:
        DefaultConfig._reset_instance_for_testing()
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        assert ours[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours['left_eye_patch'].dtype.is_floating_point is False
    assert sorted(extras) == sorted(want_extras)
    for k, v in want_extras.items():
        np.testing.assert_array_equal(np.asarray(extras[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize('module', ['cv2', 'h5py'])
def test_missing_libraries_raise_naming_them(module, datasrc, monkeypatch):
    monkeypatch.setitem(sys.modules, module, None)
    monkeypatch.setattr(pipeline.shutil, 'which', lambda name: None)
    with pytest.raises(ImportError, match=module) as info:
        pipeline.main(TINY + ['--datasrc', datasrc[0]])
    assert 'ffmpeg' in str(info.value)
