"""AOT export (``eve_tpu_torch/export.py``) against eve_tpu, on the CPU.

An artifact of the ``configs/refine_net.json``-shaped model (eve_tpu's
``init_params(PRNGKey(0))`` weights, perturbed so that every head is
live, carried into the port with ``utils/convert.py``) must give eve_tpu's
live ``forward`` at ``tests/test_export.py``'s tolerances (rtol 1e-5 /
atol 1e-4 for a whole clip, rtol 1e-4 / atol 1e-3 streamed chunk by chunk)
and the port's live forward bitwise: the program runs the same ATen ops on
the same inputs. The bfloat16 artifact and the opt-in topology's, with
each readout, are held to the port's live forward bitwise. The refine
head's final heatmap is scaled up so that ``PoG_px_final`` leaves the
screen centre; the initial PoG, gazes, pupil sizes and the returned states
are compared too.

Also: eve_tpu's refusals (a foreign file, states to a non-streaming
artifact, none to a streaming one), eve_tpu's own ``.eve`` files, another
device type or torch version; an artifact loaded and run in a process that
imports nothing of ``eve_tpu_torch.models``; both heatmap ops as nodes of
the exported graph; and a bfloat16 export before any eager bfloat16
forward in a fresh process (whose traced values once poisoned the layers'
caches).
"""

import functools
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import torch

from eve_tpu import export as jexport
from eve_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eve_tpu.models import eve as jeve
from eve_tpu_torch import export as texport
from eve_tpu_torch.data.synthetic import make_synthetic_batch
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.models import layers
from eve_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EYE, T = 32, 4
# eve_tpu's own tolerances (tests/test_export.py).
WHOLE_TOL = dict(rtol=1e-5, atol=1e-4)
STREAM_TOL = dict(rtol=1e-4, atol=1e-3)
KEYS = ('PoG_px_initial', 'PoG_px_final', 'PoG_cm_final', 'g_initial',
        'g_final', 'left_pupil_size', 'right_pupil_size')


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


@pytest.fixture(scope='module')
def model(specs, state_dict):
    return teve.build_model(specs[1], state_dict, 'cpu')


def client_batch(seed, batch_size=1, t=T, eyes=EYE, frame_dtype=np.uint8):
    """A batch as a client sends it: no labels."""
    return make_synthetic_batch(np.random.RandomState(seed),
                                batch_size=batch_size, sequence_len=t,
                                eyes_size=eyes, with_gt=False,
                                frame_dtype=frame_dtype)


def chunk(batch, start, stop):
    return {k: v[:, start:stop] for k, v in batch.items()}


def live(model, batch, **kw):
    with torch.inference_mode():
        return model(teve.batch_to_tensors(batch, 'cpu'),
                     output_predictions=True, **kw)


def jax_live(jspec, params, batch):
    return jax.jit(lambda p, b: jeve.forward(
        jspec, p, b, training=False, output_predictions=True))(params, batch)


def state_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in state_leaves(t)]
    return [tree]


def assert_bitwise(got, want, keys):
    for k in keys:
        assert torch.equal(got[k], want[k]), (k, float(
            (got[k].double() - want[k].double()).abs().max()))


@pytest.fixture(scope='module')
def whole(specs, state_dict):
    """A non-streaming artifact of B = 1, T = 3, uint8 frames: ``(batch,
    bytes, loaded)``."""
    batch = client_batch(0, t=3)
    blob = texport.export_inference(specs[1], state_dict, batch,
                                    device='cpu')
    return batch, blob, texport.load_exported(blob, device='cpu')


@pytest.fixture(scope='module')
def streaming(specs, state_dict):
    """A streaming artifact of B = 1, T = 2 chunks: ``(batch, bytes,
    loaded)``."""
    batch = client_batch(1)
    blob = texport.export_inference(specs[1], state_dict,
                                    chunk(batch, 0, T // 2), streaming=True,
                                    device='cpu')
    return batch, blob, texport.load_exported(blob, device='cpu')


def test_round_trip_matches_eve_tpu_and_the_live_forward(
        specs, params, model, whole, tmp_path):
    batch, blob, _ = whole
    path = tmp_path / 'model.pt2'
    path.write_bytes(blob)
    artifact = texport.load_exported(str(path), device='cpu')
    assert not artifact.streaming and artifact.batch_size == 1
    assert dict((k, (s, d)) for k, s, d in artifact.input_signature)[
        'left_eye_patch'] == ((1, 3, EYE, EYE, 3), 'uint8')
    out = artifact(batch)
    # A batch without labels gives a predictions-only artifact.
    assert set(out) == set(texport.EXPORTED_OUTPUTS)
    assert_bitwise(out, live(model, batch), out)
    ref = jax_live(specs[0], params, batch)
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **WHOLE_TOL)
    # The refined PoG is live, not the screen centre of a flat heatmap.
    assert float(out['PoG_px_final'].std()) > 1.0


def test_streaming_artifact_carries_state(specs, params, model, streaming):
    batch, _, artifact = streaming
    assert artifact.streaming
    states = artifact.zero_state(1)
    zero = teve.init_stream_state(specs[1], 1)
    assert [(s.shape, s.dtype) for s in state_leaves(states)] == [
        (s.shape, s.dtype) for s in state_leaves(zero)]
    live_states = zero
    outs = []
    for c in range(2):
        part = chunk(batch, c * T // 2, (c + 1) * T // 2)
        out = artifact(part, states)
        want = live(model, part, initial_states=live_states,
                    return_states=True)
        assert_bitwise(out, want, KEYS)
        for a, b in zip(state_leaves(out['states']),
                        state_leaves(want['states'])):
            assert torch.equal(a, b)
        states, live_states = out['states'], want['states']
        outs.append(out)
    ref = jax_live(specs[0], params, batch)
    for k in KEYS:
        got = torch.cat([o[k] for o in outs], dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(ref[k]), err_msg=k,
                                   **STREAM_TOL)


@pytest.mark.parametrize('readout', ['heatmap', 'gated'])
def test_native_artifacts_equal_the_live_forward(readout):
    """The opt-in topology with each readout (its seeded initialisation;
    48x48 eyes: the patchify stem's layer4 is 1x1 below 33). The bfloat16
    artifact is held the same way by
    ``test_bf16_export_before_any_eager_forward``."""
    spec = teve.EveSpec(refine_net_enabled=True, load_screen_content=True,
                        tpu_native_arch=True,
                        tpu_native_refine_head=readout)
    sd = teve.init_model(spec, torch.Generator().manual_seed(3),
                         'cpu').state_dict()
    batch = client_batch(2, t=2, eyes=48)
    artifact = texport.load_exported(
        texport.export_inference(spec, sd, batch, device='cpu'),
        device='cpu')
    out = artifact(batch)
    assert_bitwise(out, live(teve.build_model(spec, sd, 'cpu'), batch), out)


def test_exported_graph_calls_both_heatmap_ops(whole):
    _, blob, _ = whole
    program = torch.export.load(io.BytesIO(blob[16:]))
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == 'call_function'}
    assert {'eve_tpu_torch.render_heatmaps.default',
            'eve_tpu_torch.soft_argmax.default'} <= targets


def test_rejects_foreign_file(tmp_path):
    path = tmp_path / 'bogus.pt2'
    path.write_bytes(b'not an artifact' * 10)
    with pytest.raises(AssertionError, match='artifact'):
        texport.load_exported(str(path), device='cpu')


def test_refuses_eve_tpu_artifacts(specs, params):
    blob = jexport.export_inference(
        specs[0], params, jax_batch(np.random.RandomState(0), batch_size=1,
                                    sequence_len=2, eyes_size=EYE,
                                    with_gt=False))
    assert blob[:8] == texport.EVE_TPU_MAGIC
    with pytest.raises(ValueError, match='StableHLO'):
        texport.load_exported(blob, device='cpu')


def test_state_assertions(whole, streaming):
    batch, _, artifact = whole
    with pytest.raises(AssertionError, match='non-streaming'):
        artifact(batch, {})
    batch, _, artifact = streaming
    with pytest.raises(AssertionError, match='needs states'):
        artifact(chunk(batch, 0, T // 2))


def test_refuses_another_device_type_or_torch(whole, monkeypatch):
    _, blob, _ = whole
    with pytest.raises(ValueError, match='exported for cpu'):
        texport.load_exported(blob, device='cuda')
    monkeypatch.setattr(torch, '__version__', '0.0.0')
    with pytest.raises(ValueError, match='torch'):
        texport.load_exported(blob, device='cpu')


def _run(code, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2')
    return subprocess.run([sys.executable, '-c', textwrap.dedent(code)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)


def test_loads_and_runs_without_the_model_code(model, streaming, tmp_path):
    batch, blob, _ = streaming
    (tmp_path / 'model.pt2').write_bytes(blob)
    part = chunk(batch, 0, T // 2)
    np.savez(tmp_path / 'batch.npz', **part)
    want = live(model, part, initial_states=teve.init_stream_state(
        model.spec, 1), return_states=True)
    np.save(tmp_path / 'want.npy', want['PoG_px_initial'].numpy())
    proc = _run('''
        import sys
        import numpy as np
        from eve_tpu_torch.export import load_exported
        artifact = load_exported('model.pt2', device='cpu')
        with np.load('batch.npz') as z:
            batch = {k: z[k] for k in z.files}
        out = artifact(batch, artifact.zero_state(1))
        assert np.array_equal(out['PoG_px_initial'].numpy(),
                              np.load('want.npy'))
        print(sorted(m for m in sys.modules
                     if m.startswith('eve_tpu_torch.models')))
        ''', tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'


def test_bf16_export_before_any_eager_forward(tmp_path):
    """In a fresh process, export a bfloat16 model first, then run it
    eagerly: the eager forward still works and equals the artifact
    bitwise (tracing once left a data-dependent LeakyReLU slope and fake
    resize matrices in the layers' caches)."""
    proc = _run('''
        import numpy as np
        import torch
        from eve_tpu_torch import export
        from eve_tpu_torch.data.synthetic import make_synthetic_batch
        from eve_tpu_torch.models import eve
        spec = eve.EveSpec(refine_net_enabled=True, load_screen_content=True,
                           compute_dtype='bfloat16')
        model = eve.init_model(spec, torch.Generator().manual_seed(0), 'cpu')
        batch = make_synthetic_batch(np.random.RandomState(0), batch_size=1,
                                     sequence_len=2, eyes_size=32,
                                     with_gt=False, frame_dtype=np.uint8)
        blob = export.export_inference(spec, model.state_dict(), batch,
                                       device='cpu')
        with torch.inference_mode():
            want = model.eval()(eve.batch_to_tensors(batch, 'cpu'),
                                output_predictions=True)
        got = export.load_exported(blob, device='cpu')(batch)
        for k, v in got.items():
            assert type(want[k]) is torch.Tensor, (k, type(want[k]))
            assert torch.equal(v, want[k]), k
        print('ok', len(got))
        ''', tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == 'ok'


def test_bf16_leaky_slope_is_eve_tpus():
    assert layers._rounded(0.01, torch.bfloat16) == 0.010009765625
    assert layers._rounded(0.01, torch.float32) == float(
        torch.tensor(0.01, dtype=torch.float32))
    values = np.random.RandomState(0).normal(0, 10, 2000).astype(np.float32)
    values = np.concatenate([values, np.float32([
        1.00390625, 1.01171875, -1.00390625, 3e-39, 0.0])])  # ties, subnormal
    for dtype in (torch.bfloat16, torch.float16):
        want = torch.from_numpy(values).to(dtype).float().tolist()
        assert [layers._rounded(float(v), dtype) for v in values] == want
