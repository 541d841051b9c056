"""Gaze360 in the port (``eve_tpu_torch.models.gaze360``) on the CPU, at
its published channel widths on small faces (B = 2, T = 9, 64x64).

- The port against the plain reference (``benchmark/reference/gaze360.py``,
  the literal windowed forward): float32 gazes and spreads within 1e-5,
  bfloat16 within ``BF16_RAD``.
- The frames-once gather against literal windows, the clip's first and
  last frames included; the clamped window indices.
- Folded BatchNorm against the reference's written-out norms in float32.
- The backbone's frame counter (the ``gaze360.backbone`` span's key).
- ``infer.iterator`` and ``cli.eval_codalab`` on a ``gaze_net: 'gaze360'``
  configuration; an unknown ``gaze_net``.
- Serving, its CLI, export and the train harness refuse Gaze360.
"""

import gzip
import json
import os
import pickle

import numpy as np
import pytest
import torch

from benchmark import synthetic, weights as weights_lib
from benchmark.reference import gaze360 as ref
from eve_tpu_torch import infer, tracing
from eve_tpu_torch.cli import eval_codalab
from eve_tpu_torch.config import Config
from eve_tpu_torch.models import gaze360, zoo

B, T, PX = 2, 9, 64
SEEDS = (2 ** 31 + 18, 7)
# bfloat16 backbone against the float32 reference: the largest gap of 4
# CPU seeds was 4.6e-4 rad (about 0.03 degrees); 4x room.
BF16_RAD = 2e-3
CFG = {'gaze_net': 'gaze360'}
SECTION = {'std_overrides': {'last_layer.weight': 0.02,
                             'last_layer.bias': 0.005}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(seed):
    specs = ref.param_specs(CFG)
    w = weights_lib.make_weights(specs, seed, torch.device('cpu'), SECTION)
    state = dict(w)
    state.update(ref.norm_buffers(specs))
    return w, state


def _batch(seed, b=B, t=T, px=PX):
    """A face clip batch: noise faces about 600 mm in front of a camera at
    the screen's centre, each clip's face turned by up to 0.2 rad."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed % 2 ** 32)
    rot = np.stack([synthetic._rotation(rng.uniform(-0.2, 0.2, 2))
                    for _ in range(b)])
    cam = torch.eye(4).repeat(b, t, 1, 1)
    cam[..., :3, 3] = torch.tensor([-265.0, -150.0, 0.0])
    return {
        'frame': torch.randint(0, 256, (b, t, px, px, 3), dtype=torch.uint8,
                               generator=gen),
        'face_o': torch.tensor([0.0, 0.0, 600.0]) + 10.0 * torch.randn(
            b, t, 3, generator=gen),
        'face_R': torch.from_numpy(rot)[:, None].expand(b, t, 3, 3)
        .contiguous(),
        'camera_transformation': cam,
        'inv_camera_transformation': torch.linalg.inv(cam),
        'pixels_per_millimeter': torch.full((b, t, 2), 3.6),
        'millimeters_per_pixel': torch.full((b, t, 2), 1 / 3.6),
    }


def _model(state, dtype='float32'):
    spec = gaze360.GazeSpec(compute_dtype=dtype)
    return gaze360.build_model(spec, state, 'cpu')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seed', SEEDS)
def test_port_matches_the_literal_reference(dtype, seed):
    w, state = _weights(seed)
    batch = _batch(seed)
    with torch.no_grad():
        want = ref.forward(w, CFG, batch)
        got = _model(state, dtype)(batch)
    tol = 1e-5 if dtype == 'float32' else BF16_RAD
    assert (got['g_initial'] - want['g_initial']).abs().max() <= tol
    assert (got['gaze_spread'] - want['gaze_spread']).abs().max() <= tol
    assert got['g_initial'].dtype == torch.float32
    if dtype == 'float32':
        assert torch.allclose(got['PoG_px_initial'], want['PoG_px_initial'],
                              atol=1e-2)
    # The gazes differ from frame to frame: the comparison is not of
    # constants.
    assert got['g_initial'].std(dim=(0, 1)).min() > 1e-4


@pytest.mark.parametrize('t', [0, 1, T // 2, T - 2, T - 1])
def test_window_indices_clamp_at_the_clip(t):
    got = gaze360.window_indices(T)[t].tolist()
    assert got == [ref.window_frame(t, k, T) for k in range(7)]
    assert got == [min(max(t + k - 3, 0), T - 1) for k in range(7)]


@pytest.mark.parametrize('t', [0, 3, T - 1])
def test_frames_once_gather_equals_literal_windows(t):
    _, state = _weights(SEEDS[0])
    model = _model(state)
    features = torch.randn(B, T, gaze360.FEATURES,
                           generator=torch.Generator().manual_seed(t))
    window = torch.stack([features[:, min(max(t + k - 3, 0), T - 1)]
                          for k in range(7)], dim=1)
    with torch.no_grad():
        out, _ = model.lstm(window)
        want = model.last_layer(out[:, 3])
        got = model.temporal(features)[:, t]
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('seed', SEEDS)
def test_folded_norms_equal_the_written_out_ones(seed):
    """The port runs each BatchNorm folded into the convolution before it:
    its float32 features equal the reference backbone's, whose norms are
    written out with their drawn running statistics, and its state_dict
    holds the convolutions' biases and no norm."""
    w, state = _weights(seed)
    folded = _model(state)
    assert not any('.bn' in k or 'downsample.1' in k
                   for k in folded.state_dict())
    assert 'base_model.layer2.0.downsample.0.bias' in folded.state_dict()
    assert w['base_model.layer1.0.bn1.running_var'].std() > 0.01
    frames = _batch(seed)['frame'][0]
    with torch.no_grad():
        got = folded.frame_features(frames)
        want = ref.backbone(w, ref.normalise(frames))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape', [(B, T), (1, 3)])
def test_backbone_counter_reads_every_frame_once(shape):
    _, state = _weights(SEEDS[0])
    model = _model(state)
    batch = _batch(SEEDS[0], *shape)
    tracing.clear()
    with torch.profiler.profile(), torch.no_grad():
        model(batch)
    found = {s.name: s for s in tracing.spans()}
    assert found['gaze360.backbone'].key == shape[0] * shape[1]
    assert 'gaze360.temporal' in found
    tracing.clear()


def _config(**extra):
    config = Config()
    config.import_dict(dict(dict(gaze_net='gaze360', camera_frame_type='face',
                                 face_size=[PX, PX], max_sequence_len=T,
                                 load_screen_content=False,
                                 refine_net_enabled=False), **extra))
    return config


def _run_dir(tmp_path, state):
    run = tmp_path / 'run'
    run.mkdir()
    torch.save({'epoch': 3, 'state_dict': {'module.' + k: v
                                           for k, v in state.items()}},
               str(run / gaze360.PRETRAINED_FILE))
    return str(run)


def _loader_batches(n):
    out = []
    for i in range(n):
        b = {k: v.numpy() for k, v in _batch(100 + i).items()}
        b['timestamps'] = (np.arange(T, dtype=np.int64)[None].repeat(B, 0)
                           * 100_000_000 + 1_600_000_000_000_000_000)
        b['participant'] = ['test01'] * B
        b['subfolder'] = ['step00%d_image' % i] * B
        b['camera'] = ['webcam_c', 'webcam_l']
        out.append(b)
    return out


def _direct(state, batch):
    """One forward of the model on a loader batch, as numpy."""
    with torch.inference_mode():
        out = _model(state)({k: torch.from_numpy(v) for k, v in batch.items()
                             if isinstance(v, np.ndarray)
                             and k != 'timestamps'})
    return {k: v.numpy() for k, v in out.items()}


def test_infer_iterator_runs_gaze360(tmp_path):
    _, state = _weights(SEEDS[1])
    model = infer.model_setup(_config(resume_from=_run_dir(tmp_path, state)),
                              device='cpu')
    assert isinstance(model, gaze360.Gaze360)
    batches = _loader_batches(2)
    steps = list(infer.iterator(model, batches, create_images=False,
                                materialize_inputs=False))
    assert len(steps) == 2
    _, inputs, outputs = steps[1]
    direct = _direct(state, batches[1])
    assert np.allclose(outputs['g_initial'], direct['g_initial'],
                       rtol=0, atol=1e-6)
    assert outputs['PoG_px_initial'].shape == (B, T, 2)
    assert outputs['gaze_spread'].shape == (B, T)
    assert not any(k.endswith('_final') for k in outputs)
    assert outputs['timestamps'].dtype == np.int64
    with pytest.raises(ValueError, match='look-ahead'):
        next(infer.iterator(model, batches, streaming=True))


def test_eval_codalab_writes_a_gaze360_submission(tmp_path, monkeypatch):
    _, state = _weights(SEEDS[0])
    run = _run_dir(tmp_path, state)
    batches = _loader_batches(2)
    monkeypatch.setattr(eval_codalab, 'init_dataset',
                        lambda config: (None, batches))
    cfg = tmp_path / 'gaze360.json'
    cfg.write_text(json.dumps(dict(
        gaze_net='gaze360', camera_frame_type='face', face_size=[PX, PX],
        load_screen_content=False, refine_net_enabled=False)))
    zip_path = eval_codalab.main([str(cfg), '--resume-from', run,
                                  '--device', 'cpu'])
    assert os.path.isfile(zip_path)
    with gzip.open(zip_path[:-len('.zip')] + '.pkl.gz', 'rb') as f:
        written = pickle.load(f)
    direct = _direct(state, batches[0])
    entry = written['test01']['step000_image']['webcam_l']
    assert set(entry) == {'timestamps', 'PoG_px_initial'}
    assert np.allclose(entry['PoG_px_initial'], direct['PoG_px_initial'][1],
                       rtol=0, atol=1e-3)
    assert np.array_equal(entry['timestamps'], batches[0]['timestamps'][1])


def test_repository_config_selects_gaze360():
    config = Config()
    config.import_json(os.path.join(os.path.dirname(__file__), '..',
                                    'configs', 'gaze360.json'))
    spec = zoo.spec_from_config(config)
    assert isinstance(spec, gaze360.GazeSpec)
    assert config.face_size == [224, 224]


@pytest.mark.parametrize('value', ['gaze-360', 'EVE', ''])
def test_unknown_gaze_net_raises(value):
    config = Config()
    config.import_dict({'gaze_net': value})
    with pytest.raises(ValueError, match='Unknown gaze_net'):
        zoo.gaze_net(config)
    with pytest.raises(ValueError, match='Unknown gaze_net'):
        infer.model_setup(config, device='cpu')


def test_default_gaze_net_builds_eve():
    from eve_tpu_torch.models import eve as eve_lib
    config = Config()
    assert config.gaze_net == 'eve'
    assert isinstance(zoo.spec_from_config(config), eve_lib.EveSpec)
    with pytest.raises(ValueError, match="camera_frame_type 'face'"):
        zoo.spec_from_config(_config(camera_frame_type='eyes'))


def test_serving_engine_refuses_gaze360():
    from eve_tpu_torch.serve import ServingEngine
    _, state = _weights(SEEDS[0])
    with pytest.raises(ValueError, match='3-frame look-ahead'):
        ServingEngine(gaze360.GazeSpec(), state, device='cpu')


def test_serve_cli_refuses_gaze360(tmp_path):
    from eve_tpu_torch.cli import serve
    with pytest.raises(ValueError, match='3-frame look-ahead'):
        serve.model_setup(_config(resume_from=str(tmp_path)))


def test_export_refuses_gaze360(tmp_path):
    from eve_tpu_torch import export
    from eve_tpu_torch.cli import export_model
    with pytest.raises(ValueError, match='look-ahead'):
        export_model.main(['--gaze-net', 'gaze360',
                           '--camera-frame-type', 'face',
                           '--export-path', str(tmp_path / 'm.pt2'),
                           '--device', 'cpu'])
    with pytest.raises(ValueError, match='look-ahead'):
        export.export_inference(gaze360.GazeSpec(), {}, {}, device='cpu')


def test_train_harness_refuses_gaze360(tmp_path):
    from eve_tpu_torch.train import harness
    with pytest.raises(ValueError, match='pinball loss'):
        harness.Experiment(_config(), str(tmp_path), device='cpu')


@pytest.mark.parametrize('require_weights', [False, True])
def test_model_setup_without_weights(require_weights, monkeypatch):
    monkeypatch.delenv('EVE_PRETRAINED_DIR', raising=False)
    config = _config()
    if require_weights:
        with pytest.raises(RuntimeError, match='No Gaze360 weights'):
            infer.model_setup(config, require_weights=True, device='cpu')
        return
    model = infer.model_setup(config, device='cpu')
    again = infer.model_setup(config, device='cpu')
    # Seed-0 weights, folded: the same on every call.
    assert not model.training
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
