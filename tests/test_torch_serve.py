"""The port's serving engine, HTTP front end and ``--resume-from``, on the CPU.

``ServingEngine(device='cpu')`` must give what a direct forward gives, in
the port and in eve_tpu, for the ``configs/refine_net.json`` model with
every parameter perturbed; sessions must carry the recurrent state across
chunks in submission order; a failed chunk must break its session; and an
eve_tpu run directory written by ``CheckpointManager`` must serve the same
outputs in the port.

Tolerances: PoG px rtol 1e-4 / atol 1e-2 px, everything else rtol 1e-4 /
atol 1e-4 (see tests/test_torch_eve.py for the reasons; the engine adds
only a padded batch, which changes the summation blocking of oneDNN's
convolutions).
"""

import functools
import http.client
import io
import json
import os
import threading

import numpy as np
import pytest

import jax
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.data import synthetic as jsynthetic
from eve_tpu.models import eve as jeve
from eve_tpu.train.checkpoint import CheckpointManager
from eve_tpu.train.step import TrainState
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.cli import serve as cli_serve
from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.serve import (DEFAULT_SERVED_OUTPUTS, ServingEngine,
                                 UnknownSessionError, make_http_server)
from eve_tpu_torch.utils import convert

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
EYE = 48
KEYS = ('PoG_px_initial', 'PoG_px_final', 'PoG_cm_final', 'g_final',
        'left_pupil_size')


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
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    return jspec, teve.EveSpec.from_config(tc)


@pytest.fixture(scope='module')
def params(specs):
    tree = jax.jit(functools.partial(jeve.init_params, specs[0]))(
        jax.random.PRNGKey(1))
    tree = _perturb(tree, np.random.RandomState(1))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


@pytest.fixture(scope='module')
def model(specs, params):
    return teve.build_model(specs[1], convert.eve_state_dict(params), 'cpu')


@pytest.fixture
def engine(specs, params):
    eng = ServingEngine(specs[1], convert.eve_state_dict(params),
                        device='cpu', max_batch=3, max_delay_ms=200.0)
    yield eng
    eng.stop()


def _clips(seed, n, T=2):
    """n single-clip request dicts (leading dim T, uint8 frames)."""
    batch = make_synthetic_batch(np.random.RandomState(seed), batch_size=n,
                                 sequence_len=T, eyes_size=EYE,
                                 frame_dtype=np.uint8)
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def _port_direct(model, clip, **kw):
    with torch.inference_mode():
        out = model(teve.batch_to_tensors({k: v[None] for k, v in
                                           clip.items()}, 'cpu'),
                    output_predictions=True, **kw)
    return {k: v[0].numpy() for k, v in out.items()
            if k in DEFAULT_SERVED_OUTPUTS}


def _jax_direct(jspec, params, clips):
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    out = jax.jit(lambda p, b: jeve.forward(
        jspec, p, b, training=False, output_predictions=True))(params, batch)
    return [{k: np.asarray(out[k])[i] for k in DEFAULT_SERVED_OUTPUTS}
            for i in range(len(clips))]


def _assert_outputs(got, want):
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **_tolerance(key))


@pytest.mark.parametrize('frame_dtype', [np.uint8, np.float32],
                         ids=['uint8', 'float32'])
def test_synthetic_requests_match_eve_tpu(frame_dtype):
    ours = make_synthetic_batch(np.random.RandomState(5), batch_size=2,
                                sequence_len=3, eyes_size=EYE,
                                frame_dtype=frame_dtype)
    ref = jsynthetic.make_synthetic_batch(
        np.random.RandomState(5), batch_size=2, sequence_len=3,
        eyes_size=EYE, frame_dtype=frame_dtype)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        # The gaze labels come from each package's float32 geometry.
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_engine_matches_port_and_eve_tpu_forwards(specs, params, model,
                                                  engine):
    clips = _clips(0, 3)
    futures = [engine.submit(c) for c in clips]
    results = [f.result(timeout=120) for f in futures]
    jax_ref = _jax_direct(specs[0], params, clips)
    for clip, res, ref in zip(clips, results, jax_ref):
        assert set(res) == set(DEFAULT_SERVED_OUTPUTS)
        _assert_outputs(res, _port_direct(model, clip))
        _assert_outputs(res, ref)
    stats = engine.get_stats()
    assert stats['requests'] == 3
    assert stats['batches'] < 3  # back-to-back requests share a batch


def test_sessions_carry_state_in_order(model, engine):
    [clip_a, clip_b] = _clips(1, 2, T=3)
    whole_a = _port_direct(model, clip_a)
    whole_b = _port_direct(model, clip_b)
    sa, sb = engine.open_session(), engine.open_session()
    # Interleaved and submitted at once: each session's chunks must run in
    # order, one per batch, while the two sessions share batches.
    futures = []
    for t in range(3):
        for sid, clip in ((sa, clip_a), (sb, clip_b)):
            futures.append((sid, t, engine.submit(
                {k: v[t:t + 1] for k, v in clip.items()}, session_id=sid)))
    got = {sa: [], sb: []}
    for sid, t, f in futures:
        got[sid].append(f.result(timeout=120))
    for sid, whole in ((sa, whole_a), (sb, whole_b)):
        chunked = {k: np.concatenate([r[k] for r in got[sid]])
                   for k in KEYS}
        _assert_outputs(chunked, whole)
    assert engine._sessions[sa].chunks_processed == 3
    engine.close_session(sa)
    with pytest.raises(UnknownSessionError):
        engine.submit(clip_a, session_id=sa)


def test_failed_chunk_breaks_its_session(engine):
    [clip] = _clips(2, 1, T=1)
    sid = engine.open_session()
    bad = dict(clip)
    del bad['left_eye_patch']  # the forward raises on this chunk
    f_bad = engine.submit(bad, session_id=sid)
    f_next = engine.submit(clip, session_id=sid)
    with pytest.raises(KeyError):
        f_bad.result(timeout=120)
    with pytest.raises(RuntimeError, match='previous chunk'):
        f_next.result(timeout=120)
    # A fresh session is unaffected.
    engine.infer(clip, session_id=engine.open_session(), timeout=120)
    assert engine.get_stats()['errors'] == 2


def test_http_round_trip(model, engine):
    [clip] = _clips(3, 1)
    server = make_http_server(engine, host='127.0.0.1', port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request('GET', '/healthz')
        assert json.loads(conn.getresponse().read()) == {'status': 'ok'}
        conn.request('POST', '/v1/sessions')
        sid = json.loads(conn.getresponse().read())['session_id']
        buf = io.BytesIO()
        np.savez(buf, **clip)
        conn.request('POST', '/v1/infer', body=buf.getvalue(),
                     headers={'X-Session-Id': sid,
                              'Content-Type': 'application/octet-stream'})
        resp = conn.getresponse()
        assert resp.status == 200
        with np.load(io.BytesIO(resp.read())) as z:
            out = {k: z[k] for k in z.files}
        assert set(out) == set(DEFAULT_SERVED_OUTPUTS)
        _assert_outputs(out, _port_direct(model, clip))
        conn.request('DELETE', '/v1/sessions/' + sid)
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read()) == {}
        conn.request('GET', '/v1/stats')
        assert json.loads(conn.getresponse().read())['requests'] == 1
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_resume_from_serves_an_eve_tpu_checkpoint(specs, params, tmp_path):
    CheckpointManager(str(tmp_path)).save_at_step(
        7, TrainState(step=np.int32(7), params=params, opt_state=()))
    config, args = cli_serve.parse_config(
        [CONFIG, '--resume-from', str(tmp_path), '--device', 'cpu'])
    assert args.device == 'cpu'
    assert config.refine_net_rnn_type == 'CLSTM'
    spec, state_dict = cli_serve.model_setup(config)
    assert spec == specs[1]
    m = teve.build_model(spec, state_dict, 'cpu')
    clips = _clips(4, 2)
    for clip, ref in zip(clips, _jax_direct(specs[0], params, clips)):
        _assert_outputs(_port_direct(m, clip), ref)


def test_cli_refuses_random_weights():
    config, _ = cli_serve.parse_config([CONFIG])
    with pytest.raises(RuntimeError, match='--resume-from'):
        cli_serve.model_setup(config)


def test_later_slice_modes_raise(specs, params):
    """``mesh=`` takes a ``DataMesh`` or a device count and refuses
    anything else (tests/test_torch_parallel_serve.py serves with meshes);
    ``artifact=`` serves in place of spec and params, so the two together
    raise eve_tpu's ``ValueError`` (tests/test_torch_serve_artifact.py
    serves artifacts); ``device_resident=`` builds
    (tests/test_torch_serve_resident.py serves with it)."""
    sd = convert.eve_state_dict(params)
    with pytest.raises(TypeError, match='mesh'):
        ServingEngine(specs[1], sd, device='cpu', mesh=object())
    with pytest.raises(ValueError, match='not both'):
        ServingEngine(specs[1], sd, device='cpu', artifact='model.pt2')
    engine = ServingEngine(specs[1], sd, device='cpu', device_resident=True)
    try:
        assert engine.device_resident
    finally:
        engine.stop()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.cpu() if isinstance(tree, torch.Tensor)
                       else tree)]


@pytest.mark.parametrize('device_resident', [False, True],
                         ids=['host', 'resident'])
def test_spans_of_each_dispatch_and_request(specs, params, device_resident):
    """Under a profiler each dispatch gives one ``serve.dispatch`` with its
    stacking, copies and forward launch as children and one
    ``serve.queue_wait`` a request (keyed by its session); outputs and
    states equal those of the same requests served with no profiler, bit
    for bit."""
    from eve_tpu_torch import tracing
    from tests.test_torch_tracing import all_threads_profiler
    clips = _clips(3, 3, T=2)

    def serve(engine):
        sids = [engine.open_session() for _ in clips]
        outs = []
        for t in range(2):
            futures = [engine.submit({k: v[t:t + 1] for k, v in c.items()},
                                     session_id=sid)
                       for sid, c in zip(sids, clips)]
            outs.append([f.result(timeout=120) for f in futures])
        return sids, outs, [engine._sessions[s].state for s in sids]

    engine = ServingEngine(specs[1], convert.eve_state_dict(params),
                           device='cpu', max_batch=3, max_delay_ms=200.0,
                           device_resident=device_resident)
    try:
        _, plain, plain_states = serve(engine)
        tracing.clear()
        before = engine.get_stats()['batches']
        with all_threads_profiler():
            sids, traced, states = serve(engine)
        dispatches = engine.get_stats()['batches'] - before
    finally:
        engine.stop()
    for want, got in ((plain, traced), (plain_states, states)):
        for a, b in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    found = tracing.spans()
    tracing.clear()
    roots = [s for s in found if s.name == 'serve.dispatch']
    assert len(roots) == dispatches >= 2
    assert all(s.parent is None for s in found
               if s.name in ('serve.idle', 'serve.gather'))
    assert sum(s.name == 'serve.gather' for s in found) >= dispatches
    waits = []
    for root in roots:
        kids = [s for s in found if s.parent == root.id]
        names = sorted(s.name for s in kids if s.name != 'serve.queue_wait')
        want = ['serve.d2h', 'serve.forward', 'serve.h2d']
        if not device_resident:
            want = sorted(want + ['serve.d2h', 'serve.stack'])
        assert names == want
        for s in kids:
            if s.name == 'serve.queue_wait':
                assert s.start_ns <= s.end_ns == root.start_ns
                waits.append(s)
            else:
                assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert sorted(w.key for w in waits) == sorted(sids * 2)
    assert all(0 <= w.ms < 120_000 for w in waits)
