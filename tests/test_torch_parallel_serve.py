"""``ServingEngine(mesh=)`` of the port against eve_tpu's, on the CPU.

The port's engine serves over a ``DataMesh`` of 2 and 4 CPU replicas (one
device listed n times: the slot slices, the per-slice forwards and the
row-order gather all run), default and ``device_resident``; eve_tpu's
engine serves over a 2- and 4-device virtual CPU mesh
(``tests/conftest.py``), default and ``device_resident``. Both get the
same requests: 3 sessions x 2 chunks of T = 2 and a session-less request
each round, with ``max_batch`` 4, on the ``configs/refine_net.json``
model (32x32 eyes) with every parameter perturbed.

Tolerances are ``tests/test_torch_serve.py``'s: PoG px rtol 1e-4 + atol
1e-2 px, everything else rtol 1e-4 + atol 1e-4. The port's mesh engine
against its own one-device engine: the same tolerances (each slice is a
smaller batch, which changes oneDNN's summation blocking), states
included.
"""

import functools
import os

import numpy as np
import pytest

import jax
import torch

from eve_tpu import serve as jserve
from eve_tpu.config import DefaultConfig
from eve_tpu.models import eve as jeve
from eve_tpu.parallel import mesh as jmesh
from eve_tpu_torch import config as tconfig
from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.parallel import mesh as tmesh
from eve_tpu_torch.serve import DEFAULT_SERVED_OUTPUTS, ServingEngine
from eve_tpu_torch.utils import convert
from eve_tpu_torch.utils.tensors import tree_map

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
EYE, T, SESSIONS, CHUNKS, MAX_BATCH = 32, 2, 3, 2, 4


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
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
        jax.random.PRNGKey(2))
    tree = _perturb(tree, np.random.RandomState(2))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    return tree


def _requests():
    """Per round: each session's chunk, then one session-less clip."""
    batch = make_synthetic_batch(np.random.RandomState(5),
                                 batch_size=SESSIONS + CHUNKS,
                                 sequence_len=CHUNKS * T, eyes_size=EYE,
                                 frame_dtype=np.uint8)
    rounds = []
    for c in range(CHUNKS):
        window = slice(c * T, (c + 1) * T)
        rounds.append([{k: v[s, window] for k, v in batch.items()}
                       for s in range(SESSIONS)] +
                      [{k: v[SESSIONS + c, :T] for k, v in batch.items()}])
    return rounds


def _serve(engine):
    """Every round's requests submitted together; ``(outputs by round and
    request, the sessions' final states)``."""
    sids = [engine.open_session() for _ in range(SESSIONS)]
    results = []
    for clips in _requests():
        futures = [engine.submit(clip, sid) for clip, sid in
                   zip(clips, sids + [None])]
        results.append([f.result(timeout=300) for f in futures])
    states = [engine._sessions[sid].state for sid in sids]
    engine.stop()
    return results, states


@pytest.fixture(scope='module')
def eve_tpu_served(specs, params):
    """eve_tpu's engine over an n-device mesh, by (n, device_resident)."""
    cache = {}

    def get(n, resident):
        if (n, resident) not in cache:
            engine = jserve.ServingEngine(
                specs[0], params, max_batch=MAX_BATCH, max_delay_ms=500.0,
                mesh=jmesh.make_mesh(n), device_resident=resident)
            cache[n, resident] = _serve(engine)[0]
        return cache[n, resident]
    return get


@pytest.fixture(scope='module')
def port_served(specs, params):
    """The port's engine, by (mesh size or None, device_resident)."""
    cache = {}
    sd = convert.eve_state_dict(params)

    def get(n, resident):
        if (n, resident) not in cache:
            mesh = None if n is None else tmesh.make_mesh(
                devices=['cpu'] * n)
            engine = ServingEngine(specs[1], sd, device='cpu',
                                   max_batch=MAX_BATCH, max_delay_ms=500.0,
                                   mesh=mesh, device_resident=resident)
            if mesh is not None:
                assert engine.mesh.size == n
            cache[n, resident] = _serve(engine)
        return cache[n, resident]
    return get


def _assert_outputs(got, want, what):
    for r, (ours, ref) in enumerate(zip(got, want)):
        for i, (o, w) in enumerate(zip(ours, ref)):
            assert set(o) == set(DEFAULT_SERVED_OUTPUTS), what
            for k in DEFAULT_SERVED_OUTPUTS:
                np.testing.assert_allclose(
                    np.asarray(o[k]), np.asarray(w[k]),
                    err_msg='%s round %d request %d %s' % (what, r, i, k),
                    **_tolerance(k))


@pytest.mark.parametrize('resident', [False, True],
                         ids=['default', 'resident'])
@pytest.mark.parametrize('n', [2, 4])
def test_mesh_engine_matches_eve_tpus(n, resident, eve_tpu_served,
                                      port_served):
    """The port's n-replica engine serves what eve_tpu's n-device mesh
    engine serves, in the same mode."""
    ours, _ = port_served(n, resident)
    _assert_outputs(ours, eve_tpu_served(n, resident),
                    'mesh %d resident=%s' % (n, resident))


@pytest.mark.parametrize('resident', [False, True],
                         ids=['default', 'resident'])
def test_mesh_engine_matches_one_device(resident, port_served):
    """Outputs and the sessions' carried states of the 4-replica engine
    equal the one-device engine's: a session's result does not depend on
    the slot, or the device, it lands on."""
    (ours, states), (one, one_states) = (port_served(4, resident),
                                         port_served(None, resident))
    _assert_outputs(ours, one, 'mesh 4 vs one device')
    for got, want in zip(states, one_states):
        pairs = []
        tree_map(lambda a, b: pairs.append((a, b)), got, want)
        for a, b in pairs:
            a, b = (np.asarray(x.float().cpu()) if isinstance(x, torch.Tensor)
                    else x for x in (a, b))
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_mesh_contract(specs, params):
    """eve_tpu's refusals: ``max_batch`` must divide by the mesh, and a
    mesh needs spec+params; an int is a device count; a mesh larger than
    the visible devices raises."""
    sd = convert.eve_state_dict(params)
    with pytest.raises(ValueError, match='must divide by the 3-device'):
        ServingEngine(specs[1], sd, device='cpu', max_batch=4,
                      mesh=tmesh.make_mesh(devices=['cpu'] * 3))
    with pytest.raises(ValueError, match='mesh serving needs spec'):
        ServingEngine(artifact=b'not read', device='cpu', mesh=2)
    engine = ServingEngine(specs[1], sd, device='cpu', max_batch=4, mesh=2)
    try:
        assert engine.mesh.devices == (torch.device('cpu'),) * 2
        # Replicas on one device are one module.
        assert engine._replicas[0] is engine._replicas[1] is engine.model
    finally:
        engine.stop()
    with pytest.raises(ValueError, match='need 2 devices, have 1'):
        tmesh.make_mesh(2, devices=['cpu'])


def test_cli_serves_over_serve_num_devices(tmp_path, monkeypatch):
    """``--serve-num-devices 2`` reaches the engine ``cli.serve`` builds:
    two replicas of the CPU device (``make_mesh(2)`` over the cards when
    the device is 'cuda')."""
    import signal

    from eve_tpu_torch import serve as serve_lib
    from eve_tpu_torch.cli import serve as cli_serve
    from eve_tpu_torch.train import checkpoint as tckpt
    from eve_tpu_torch.train import step as tstep
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict({'eyes_size': [EYE, EYE]})
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
                        'cpu', '--eyes-size', '[32, 32]',
                        '--serve-num-devices', '2'])
    finally:
        signal.signal(signal.SIGTERM, handler)
    (engine,) = built
    assert engine.mesh.devices == (torch.device('cpu'),) * 2
    assert engine._stop.is_set()
