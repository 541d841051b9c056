"""``ServingEngine(artifact=...)``, ``cli.serve --serve-artifact`` and
``cli.export_model``, on the CPU.

eve_tpu's contract (``eve_tpu/serve.py``, ``tests/test_export.py``): the
engine takes ``max_batch`` from the artifact, serves its one signature and
refuses others with an error naming it; a streaming artifact serves
sessions, and session-less requests from zero states of the artifact's own
types; a non-streaming one refuses sessions; spec+params together with an
artifact, or neither, or an artifact with ``device_resident``, raise
``ValueError``. The served outputs must equal eve_tpu's live forward at
``tests/test_export.py``'s tolerance (rtol 1e-4 / atol 1e-3) and the
port's live engine on the same batches bitwise. The export CLI reads a
checkpoint in eve_tpu's layout and builds its example batch as eve_tpu's
does (uint8 frames iff ``tpu_on_device_preprocess``); the serving CLI
serves an artifact without reading a checkpoint.

Weights: eve_tpu's ``init_params(PRNGKey(0))``, perturbed so that every
head is live, carried into the port with ``utils/convert.py``; 32x32 eyes,
clips of T = 2 (a session streams two of them).
"""

import functools
import http.client
import io
import json
import signal
import threading

import numpy as np
import pytest

import jax
import torch

from eve_tpu.models import eve as jeve
from eve_tpu.train.checkpoint import CheckpointManager
from eve_tpu.train.step import TrainState
from eve_tpu_torch import config as tconfig
from eve_tpu_torch import export as texport
from eve_tpu_torch import infer as tinfer
from eve_tpu_torch.cli import export_model as cli_export
from eve_tpu_torch.cli import serve as cli_serve
from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.serve import ServingEngine, make_http_server
from eve_tpu_torch.utils import convert

EYE, T, B = 32, 2, 2
TOL = dict(rtol=1e-4, atol=1e-3)  # eve_tpu's streamed tolerance
KEYS = ('PoG_px_initial', 'PoG_px_final', 'g_initial', 'g_final',
        'left_pupil_size', 'right_pupil_size')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope='module')
def specs():
    kw = dict(refine_net_enabled=True, load_screen_content=True)
    return jeve.EveSpec(**kw), teve.EveSpec(**kw)


@pytest.fixture(scope='module')
def params(specs):
    tree = jax.jit(functools.partial(jeve.init_params, specs[0]))(
        jax.random.PRNGKey(0))
    tree = _perturb(tree, np.random.RandomState(0))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


@pytest.fixture(scope='module')
def state_dict(params):
    return convert.eve_state_dict(params)


def clips(seed, n, t=T, frame_dtype=np.uint8):
    """``n`` requests of ``t`` frames, as a client sends them."""
    batch = make_synthetic_batch(np.random.RandomState(seed), batch_size=n,
                                 sequence_len=t, eyes_size=EYE,
                                 with_gt=False, frame_dtype=frame_dtype)
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def stacked(requests):
    return {k: np.stack([r[k] for r in requests]) for k in requests[0]}


def jax_live(jspec, params, requests):
    out = jax.jit(lambda p, b: jeve.forward(
        jspec, p, b, training=False, output_predictions=True))(
            params, stacked(requests))
    return [{k: np.asarray(out[k])[i] for k in KEYS}
            for i in range(len(requests))]


@pytest.fixture(scope='module')
def streaming_blob(specs, state_dict):
    return texport.export_inference(specs[1], state_dict,
                                    stacked(clips(0, B)), streaming=True,
                                    device='cpu')


@pytest.fixture(scope='module')
def stateless_blob(specs, state_dict):
    return texport.export_inference(specs[1], state_dict,
                                    stacked(clips(0, B)), device='cpu')


@pytest.fixture
def live_engine(specs, state_dict):
    engine = ServingEngine(specs[1], state_dict, device='cpu', max_batch=B,
                           max_delay_ms=10.0)
    yield engine
    engine.stop()


def serve_sessions(engine, streams):
    """Each stream's two chunks through a session of its own, each chunk
    round submitted together (one dispatch), then one session-less
    request; ``(per-stream concatenated outputs, loose output)``."""
    sids = [engine.open_session() for _ in streams]
    got = [[] for _ in streams]
    for c in range(2):
        futures = [engine.submit({k: v[c * T:(c + 1) * T]
                                  for k, v in s.items()}, session_id=sid)
                   for s, sid in zip(streams, sids)]
        for i, f in enumerate(futures):
            got[i].append(f.result(timeout=300))
    for sid in sids:
        engine.close_session(sid)
    loose = engine.infer({k: v[:T] for k, v in streams[0].items()},
                         timeout=300)
    return [{k: np.concatenate([o[k] for o in g]) for k in KEYS}
            for g in got], loose


def test_engine_from_streaming_artifact(specs, params, streaming_blob,
                                        live_engine, caplog):
    engine = ServingEngine(artifact=streaming_blob, device='cpu',
                           max_delay_ms=10.0)
    try:
        assert engine.max_batch == B  # taken from the artifact
        assert 'overridden' in caplog.text
        assert engine.model is None
        streams = clips(1, B, t=2 * T)
        ours, loose = serve_sessions(engine, streams)
        live, live_loose = serve_sessions(live_engine, streams)
        for got, want in zip(ours + [loose], live + [live_loose]):
            for k in KEYS:
                assert np.array_equal(got[k], want[k]), k
        for got, want in zip(ours, jax_live(specs[0], params, streams)):
            for k in KEYS:
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **TOL)
        # Another T is not the artifact's one signature.
        bad = {k: v[:3] for k, v in streams[0].items()}
        with pytest.raises(RuntimeError, match='signature'):
            engine.infer(bad, timeout=300)
    finally:
        engine.stop()


def test_engine_from_nonstreaming_artifact(specs, params, stateless_blob,
                                           live_engine):
    engine = ServingEngine(artifact=texport.load_exported(stateless_blob,
                                                          device='cpu'),
                           device='cpu', max_batch=B, max_delay_ms=10.0)
    try:
        with pytest.raises(RuntimeError, match='streaming'):
            engine.open_session()
        requests = clips(2, B)
        futures = [engine.submit(r) for r in requests]
        ours = [f.result(timeout=300) for f in futures]
        futures = [live_engine.submit(r) for r in requests]
        live = [f.result(timeout=300) for f in futures]
        for got, want, ref in zip(ours, live,
                                  jax_live(specs[0], params, requests)):
            for k in KEYS:
                assert np.array_equal(got[k], want[k]), k
                np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
    finally:
        engine.stop()


def test_engine_value_errors(specs, state_dict, stateless_blob):
    with pytest.raises(ValueError, match='not both'):
        ServingEngine(specs[1], state_dict, artifact=stateless_blob,
                      device='cpu')
    with pytest.raises(ValueError, match='or artifact'):
        ServingEngine(device='cpu')
    with pytest.raises(ValueError, match='needs the spec\\+params path'):
        ServingEngine(artifact=stateless_blob, device='cpu',
                      device_resident=True)
    with pytest.raises(ValueError, match='mesh serving needs spec'):
        ServingEngine(artifact=stateless_blob, device='cpu', mesh=2)
    # An artifact serves only on the device type it was exported for.
    with pytest.raises(ValueError, match='exported for cpu'):
        ServingEngine(artifact=stateless_blob, device='cuda')
    loaded = texport.load_exported(stateless_blob, device='cpu')
    with pytest.raises(ValueError, match='cannot serve on cuda'):
        ServingEngine(artifact=loaded, device='cuda')


def test_http_over_an_artifact_engine(streaming_blob):
    engine = ServingEngine(artifact=streaming_blob, device='cpu',
                           max_delay_ms=10.0)
    server = make_http_server(engine, host='127.0.0.1', port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        [clip] = clips(3, 1)
        want = engine.infer(clip, session_id=engine.open_session(),
                            timeout=300)
        conn = http.client.HTTPConnection(*server.server_address,
                                          timeout=300)
        conn.request('POST', '/v1/sessions')
        sid = json.loads(conn.getresponse().read())['session_id']
        buf = io.BytesIO()
        np.savez(buf, **clip)
        conn.request('POST', '/v1/infer', body=buf.getvalue(),
                     headers={'X-Session-Id': sid})
        resp = conn.getresponse()
        assert resp.status == 200
        with np.load(io.BytesIO(resp.read())) as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == set(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), k
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_serves_an_artifact_without_a_checkpoint(stateless_blob,
                                                     tmp_path, monkeypatch):
    from eve_tpu_torch import serve as serve_lib
    path = tmp_path / 'model.pt2'
    path.write_bytes(stateless_blob)
    built = []

    class Recorder(ServingEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    class Server:
        server_address = ('127.0.0.1', 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            pass

        def server_close(self):
            pass

    def no_checkpoint(config):
        raise AssertionError('model_setup called')

    monkeypatch.setattr(serve_lib, 'ServingEngine', Recorder)
    monkeypatch.setattr(serve_lib, 'make_http_server',
                        lambda engine, **kw: Server())
    monkeypatch.setattr(cli_serve, 'model_setup', no_checkpoint)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        cli_serve.main(['--serve-artifact', str(path), '--device', 'cpu'])
    finally:
        signal.signal(signal.SIGTERM, handler)
    (engine,) = built
    assert engine.model is None and engine.max_batch == B
    assert engine._stop.is_set()


def test_export_cli_from_an_eve_tpu_checkpoint(specs, params, tmp_path,
                                               monkeypatch):
    """A checkpoint in eve_tpu's layout, exported streaming with uint8
    frames (``--tpu-on-device-preprocess yes``), then loaded and run."""
    monkeypatch.chdir(tmp_path)
    run = tmp_path / 'run'
    CheckpointManager(str(run)).save_at_step(
        3, TrainState(step=np.int32(3), params=params, opt_state=()))
    out = tmp_path / 'model.pt2'
    cli_export.main(['--resume-from', str(run), '--export-path', str(out),
                     '--export-batch-size', '1', '--max-sequence-len',
                     str(T), '--eyes-size', '[32, 32]', '--device', 'cpu',
                     '--export-streaming', 'yes',
                     '--tpu-on-device-preprocess', 'yes'])
    artifact = texport.load_exported(str(out), device='cpu')
    assert artifact.streaming and artifact.batch_size == 1
    signature = {k: (s, d) for k, s, d in artifact.input_signature}
    assert signature['left_eye_patch'] == ((1, T, EYE, EYE, 3), 'uint8')
    assert signature['screen_frame'] == ((1, T, 72, 128, 3), 'uint8')
    assert not any(k.endswith('_tobii') for k in signature)
    requests = clips(4, 1)
    got = artifact(stacked(requests), artifact.zero_state(1))
    (want,) = jax_live(specs[0], params, requests)
    for k in KEYS:
        np.testing.assert_allclose(got[k][0].numpy(), want[k], err_msg=k,
                                   **TOL)


def test_export_cli_example_follows_eve_tpus_defaults(tmp_path,
                                                      monkeypatch):
    """Without flags: refuses no weights, then (weights found) a
    non-streaming float32-frame example batch without labels, as
    eve_tpu's CLI builds it; the export keys are real keys."""
    with pytest.raises(ValueError, match='export-path'):
        cli_export.main(['--device', 'cpu'])
    monkeypatch.setenv('EVE_PRETRAINED_DIR', str(tmp_path))
    with pytest.raises(RuntimeError, match='No eye_net \\+ refine_net'):
        cli_export.main(['--export-path', str(tmp_path / 'm.pt2'),
                         '--device', 'cpu'])
    seen = {}

    def record(spec, state_dict, example, streaming=False, device='cuda'):
        seen.update(spec=spec, example=example, streaming=streaming,
                    device=device)
        return b''

    def seeded(config, require_weights, device):
        assert require_weights
        return teve.init_model(teve.EveSpec.from_config(config),
                               torch.Generator().manual_seed(0),
                               device).eval()

    monkeypatch.setattr(texport, 'export_inference', record)
    monkeypatch.setattr(tinfer, 'model_setup', seeded)
    cli_export.main(['--export-path', str(tmp_path / 'm.pt2'), '--device',
                     'cpu', '--max-sequence-len', '3', '--eyes-size',
                     '[32, 32]', '--export-batch-size', '2'])
    assert not seen['streaming'] and seen['device'] == 'cpu'
    assert seen['spec'].refine_net_enabled and \
        seen['spec'].load_screen_content
    example = seen['example']
    assert example['left_eye_patch'].dtype == np.float32
    assert example['left_eye_patch'].shape == (2, 3, EYE, EYE, 3)
    assert example['screen_frame'].shape == (2, 3, 72, 128, 3)
    assert not any(k.endswith(('_tobii', '_p')) for k in example)
    cfg = tconfig.Config()
    cfg.import_dict({'export_path': 'm.pt2', 'export_batch_size': 4,
                     'export_streaming': True,
                     'tpu_on_device_preprocess': True})
    assert (cfg.export_path, cfg.export_batch_size, cfg.export_streaming,
            cfg.tpu_on_device_preprocess) == ('m.pt2', 4, True, True)
    assert not {'export_path', 'export_batch_size', 'export_streaming',
                'tpu_on_device_preprocess'} & tconfig.DEFERRED_KEYS
