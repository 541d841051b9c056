"""``ServingEngine(device_resident=True)`` against the default engine, on the CPU.

eve_tpu's ``device_resident`` mode keeps each session's recurrent states on
the device, in the model's own types, and assembles the batch there; the
default mode stacks on the host and keeps float32 numpy states. Both run
the same padded batch through the same forward, so every served output and
every session state must be equal, bitwise. The batches are made equal by
submitting each round of requests together and waiting for its answers
(8 sessions x 3 chunks and session-less requests, ``max_batch`` 8, rounds
of 8, 7 and 4 requests).

The weights are the port's seeded initialisation with every parameter
perturbed (so no head is zero); eyes are 48x48 for the reference topology
and 64x64 for the opt-in one, T = 2 frames a chunk.
"""

import os
import signal

import numpy as np
import pytest
import torch

from eve_tpu_torch import config as tconfig
from eve_tpu_torch.cli import serve as cli_serve
from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.serve import DEFAULT_SERVED_OUTPUTS, ServingEngine
from eve_tpu_torch.train import checkpoint as tckpt
from eve_tpu_torch.train import step as tstep

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
SESSIONS, CHUNKS, T, MAX_BATCH = 8, 3, 2, 8
# (session, chunk) requests of each round, and session-less ones ('loose').
ROUNDS = (
    [(s, 0) for s in range(8)],
    [(s, 1) for s in range(6)] + [('loose', 0)],
    [(6, 1), (7, 1)] + [(s, 2) for s in range(6)],
    [(6, 2), (7, 2), ('loose', 1), ('loose', 2)],
)


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _config(**overrides):
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict(dict({'eye_net_load_pretrained': False}, **overrides))
    return tc


def _weights(spec, seed=0):
    """The seeded initialisation, every parameter perturbed."""
    model = teve.init_model(spec, torch.Generator().manual_seed(seed), 'cpu')
    noise = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.05 * torch.randn(v.shape, generator=noise)
            for k, v in model.state_dict().items()}


def _streams(eyes, seed=1):
    batch = make_synthetic_batch(np.random.RandomState(seed),
                                 batch_size=SESSIONS + 3,
                                 sequence_len=CHUNKS * T, eyes_size=eyes,
                                 frame_dtype=np.uint8)
    inputs = {k: v for k, v in batch.items()
              if not k.endswith(('_tobii', '_tobii_validity', '_p',
                                 '_p_validity'))}
    return [{k: v[i] for k, v in inputs.items()}
            for i in range(SESSIONS + 3)]


def _request(streams, key, as_tensor=False):
    s, c = key
    stream, c = (streams[SESSIONS + c], 0) if s == 'loose' else (
        streams[s], c)
    clip = {k: v[c * T:(c + 1) * T] for k, v in stream.items()}
    if as_tensor:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in clip.items()}
    return clip


def serve_rounds(engine, streams, as_tensor=False, rounds=ROUNDS):
    """Every round's requests submitted together, then awaited: ``(results
    by key, the sessions' final states)``."""
    sids = [engine.open_session() for _ in range(SESSIONS)]
    results = {}
    for keys in rounds:
        futures = {key: engine.submit(
            _request(streams, key, as_tensor),
            None if key[0] == 'loose' else sids[key[0]]) for key in keys}
        results.update({k: f.result(timeout=600) for k, f in futures.items()})
    with engine._sessions_lock:
        states = [engine._sessions[sid].state for sid in sids]
    return results, states


def _engine(spec, weights, **kw):
    return ServingEngine(spec, weights, device='cpu', max_batch=MAX_BATCH,
                         max_delay_ms=300.0, **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_equal_runs(default, resident, dtype):
    (res_d, st_d), (res_r, st_r) = default, resident
    assert set(res_d) == set(res_r)
    for key in res_d:
        assert set(res_d[key]) == set(res_r[key]) == set(
            DEFAULT_SERVED_OUTPUTS)
        for k, v in res_d[key].items():
            np.testing.assert_array_equal(res_r[key][k], v,
                                          err_msg='%s %s' % (key, k))
    for host, dev in zip(st_d, st_r):
        host, dev = _leaves(host), _leaves(dev)
        assert len(host) == len(dev) > 0
        for h, d in zip(host, dev):
            assert isinstance(h, np.ndarray) and h.dtype == np.float32
            assert isinstance(d, torch.Tensor) and d.shape[0] == 1
            np.testing.assert_array_equal(d.float().numpy(), h)
    refine = [_leaves(st['refine']) for st in st_r]
    eye = [_leaves(st['eye_left']) + _leaves(st['eye_right']) for st in st_r]
    assert {t.dtype for ts in refine for t in ts} == {dtype}
    assert {t.dtype for ts in eye for t in ts} == {torch.float32}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_resident_engine_equals_default_engine(dtype):
    spec = teve.EveSpec.from_config(_config(tpu_compute_dtype=dtype))
    weights = _weights(spec)
    streams = _streams(48)
    runs = []
    for resident in (False, True):
        engine = _engine(spec, weights, device_resident=resident)
        try:
            runs.append(serve_rounds(engine, streams))
            assert engine.get_stats()['batches'] == len(ROUNDS)
        finally:
            engine.stop()
    _assert_equal_runs(*runs, torch.bfloat16 if dtype == 'bfloat16'
                       else torch.float32)
    # Each session's state is its own clone, not a view of the batch.
    for state in runs[1][1]:
        for t in _leaves(state):
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_tensor_inputs_pass_through_submit():
    """A tensor reaches the resident engine's batch assembly untouched; the
    default engine takes it as numpy. Both give the numpy inputs'
    results."""
    spec = teve.EveSpec.from_config(_config())
    weights = _weights(spec, seed=2)
    streams = _streams(48, seed=3)
    rounds = ROUNDS[:1]
    runs = {}
    for resident in (False, True):
        for as_tensor in (False, True):
            engine = _engine(spec, weights, device_resident=resident)
            seen = []
            dispatch = engine._dispatch

            def spy(reqs, dispatch=dispatch, seen=seen):
                seen.extend(r.inputs for r in reqs)
                return dispatch(reqs)

            engine._dispatch = spy
            try:
                runs[resident, as_tensor] = serve_rounds(
                    engine, streams, as_tensor, rounds)
            finally:
                engine.stop()
            kinds = {type(v) for inputs in seen for v in inputs.values()}
            assert kinds == {torch.Tensor if as_tensor else np.ndarray}
    for key, run in runs.items():
        for k, out in run[0].items():
            for name, v in out.items():
                np.testing.assert_array_equal(
                    v, runs[False, False][0][k][name], err_msg=str(key))


def test_native_topology_serves_in_both_modes():
    """tpu_native_arch (patchify stem, gated RefineNetTPU): both modes
    equal, and a session's chunks equal one forward over its stream."""
    spec = teve.EveSpec.from_config(_config(
        tpu_native_arch=True, tpu_native_refine_head='gated'))
    weights = _weights(spec, seed=4)
    streams = _streams(64, seed=5)
    rounds = ([(s, 0) for s in range(8)], [(s, 1) for s in range(8)],
              [(s, 2) for s in range(8)])
    runs = []
    for resident in (False, True):
        engine = _engine(spec, weights, device_resident=resident)
        try:
            runs.append(serve_rounds(engine, streams, rounds=rounds))
        finally:
            engine.stop()
    _assert_equal_runs(*runs, torch.float32)
    model = teve.build_model(spec, weights, 'cpu')
    batch = {k: np.stack([st[k] for st in streams[:SESSIONS]])
             for k in streams[0]}
    with torch.inference_mode():
        whole = model(teve.batch_to_tensors(batch, 'cpu'),
                      output_predictions=True)
    for k in ('PoG_px_initial', 'PoG_px_final', 'g_final'):
        got = np.stack([np.concatenate([runs[1][0][(s, c)][k]
                                        for c in range(CHUNKS)])
                        for s in range(SESSIONS)])
        np.testing.assert_allclose(
            got, whole[k].numpy(), rtol=1e-4,
            atol=1e-2 if 'PoG_px' in k else 1e-4, err_msg=k)


def test_artifact_with_device_resident_raises_eve_tpus_error():
    spec = teve.EveSpec.from_config(_config())
    with pytest.raises(ValueError, match='needs the spec\\+params path'):
        ServingEngine(None, None, artifact='model.eve', device='cpu',
                      device_resident=True)
    with pytest.raises(ValueError, match='needs the spec\\+params path'):
        ServingEngine(spec, {}, artifact='model.eve', device='cpu',
                      device_resident=True)
    with pytest.raises(NotImplementedError, match='later slice'):
        ServingEngine(spec, {}, mesh=object(), device='cpu',
                      device_resident=True)


def test_cli_builds_a_resident_engine(tmp_path, monkeypatch):
    """``--serve-device-resident yes`` reaches the engine ``cli.serve``
    builds."""
    from eve_tpu_torch import serve as serve_lib
    tc = _config()
    model = teve.init_model(teve.EveSpec.from_config(tc),
                            torch.Generator().manual_seed(0), 'cpu')
    tckpt.CheckpointManager(str(tmp_path)).save_at_step(
        1, tstep.create_train_state(tc, model, 4))
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

    monkeypatch.setattr(serve_lib, 'ServingEngine', Recorder)
    monkeypatch.setattr(serve_lib, 'make_http_server',
                        lambda engine, **kw: Server())
    handler = signal.getsignal(signal.SIGTERM)
    try:
        cli_serve.main([CONFIG, '--resume-from', str(tmp_path), '--device',
                        'cpu', '--serve-device-resident', 'yes'])
    finally:
        signal.signal(signal.SIGTERM, handler)
    (engine,) = built
    assert engine.device_resident and engine.device == torch.device('cpu')
    assert engine._stop.is_set()
