"""The bfloat16 compute path: the port against eve_tpu at bfloat16, on the CPU.

Both packages build ``configs/refine_net.json`` with ``tpu_compute_dtype``
'bfloat16'; the weights are eve_tpu's ``init_params``, perturbed so that
every head is live (the pupil head's bias is raised so its ReLU passes),
carried into the port with ``utils.convert`` (the parameters stay float32).

eve_tpu's bfloat16 programs are compiled with XLA's
``xla_allow_excess_precision`` off. Otherwise XLA on the CPU keeps a fused
chain of bfloat16 elementwise operations in float32 and rounds once at its
end, where the JAX program, and PyTorch op by op, round each operation's
result to bfloat16; with excess precision the port's forward is as far
from eve_tpu's bfloat16 forward as that is from eve_tpu's float32 one
(measured).

Yardstick: bfloat16 rounding is chaotic through instance norms. A conv
output one ulp apart (the two libraries sum in other orders, ~5e-5 of the
outputs) moves its channel's statistics and flips the rounding of other
elements, and by ResNet-18's layer4 ~20% of the activations differ. So
two faithful bfloat16 implementations do not agree to bfloat16 precision,
and the port is held against eve_tpu's own bfloat16-vs-float32 drift on
the same inputs: each output's error (port at bfloat16 vs eve_tpu at
bfloat16) over its drift (eve_tpu at bfloat16 vs eve_tpu at float32) is
printed and held below a limit. Where an operation has no such chaos, it
is held to eve_tpu bitwise or within one bfloat16 ulp.

- Layers: the bilinear resize and the leaky ReLU bitwise; the
  convolution (bias added after it) and the instance norm within one
  bfloat16 ulp at under 0.1% and 1% of the elements (sums in other
  orders), and a 1x1 map normalises to 0 (then the bias).
- ResNet-18, RefineNet's encoder and decoder (each fed eve_tpu's own
  input): ratio below 1 (measured 0.27-0.72).
- One CLSTM step with bfloat16 input and states: each output within two
  bfloat16 ulps of its largest element (measured one). XLA lowers a
  bfloat16 sigmoid as ``1 / (1 + exp(-x))`` with each operation rounded,
  where PyTorch rounds it once (an ulp apart at a third of the elements,
  measured), and ``f * c + i * g`` carries that ulp of a gate times c.
- The whole forward, uint8 and float32 frames, over 8 seeds of B = 2,
  T = 3 clips of 48x48 eyes: every per-frame output's ratio below 1
  (measured 0.34-0.73; the refined PoG 0.58 and 0.69), every 0-dim loss
  and metric's below 1.25 (measured up to 1.07: a mean over frames cancels
  its drift by chance as much as its error, and 8 values give a rough
  ratio). Outputs that do not pass the networks (labels, geometry) agree
  at float32.
- Types: forward hooks check that every convolution of the ResNet and of
  RefineNet receives bfloat16 and the GRU float32; the heatmaps, PoGs and
  losses are float32; ``compute_dtype`` 'float16' runs float32.
- Streaming, serving and ``infer.iterator`` carry bfloat16 RefineNet
  states, and chunks equal one clip within the same yardstick: the port's
  own bfloat16-vs-float32 drift over the clip. A chunk runs the
  convolutions at another batch size, where oneDNN sums in another order,
  and a flipped rounding grows as above (measured 2.9 px of refined PoG
  against a drift of tens of px).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu.config import DefaultConfig
from eve_tpu.data.synthetic import make_synthetic_batch
from eve_tpu.models import cells as jcells
from eve_tpu.models import eve as jeve
from eve_tpu.models import layers as jlayers
from eve_tpu.models import refine_net as jrefine
from eve_tpu.models import resnet as jresnet
from eve_tpu_torch import config as tconfig
from eve_tpu_torch import infer
from eve_tpu_torch.models import cells as tcells
from eve_tpu_torch.models import eve as teve
from eve_tpu_torch.models import layers as tlayers
from eve_tpu_torch.models import refine_net as trefine
from eve_tpu_torch.models import resnet as tresnet
from eve_tpu_torch.serve import ServingEngine
from eve_tpu_torch.utils import convert

CONFIG = os.path.join(os.path.dirname(__file__), '..', 'configs',
                      'refine_net.json')
EYE = 48
NO_EXCESS = {'xla_allow_excess_precision': False}
SEEDS = range(1, 9)
# Limits on error / drift (module docstring).
FRAME_RATIO, SCALAR_RATIO, MODULE_RATIO = 1.0, 1.25, 1.0


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads a test process: the suite runs several processes
    on the host's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def jit_bf16(fn, *args):
    """``fn`` compiled for ``args`` with per-operation bfloat16 rounding."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


def _perturb(tree, rng, scale=0.05):
    return {k: _perturb(v, rng, scale) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, scale, np.shape(v))).astype(
                np.float32)
            for k, v in tree.items()}


def _load(module, sd):
    module.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _nchw(x, dtype=torch.float32):
    """NHWC array (any float type) -> NCHW torch tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(_f32(x), -1, 1))).to(dtype)


def _to_nchw(x):
    return np.moveaxis(_f32(x), -1, 1)


def _max(a):
    return float(np.abs(a).max()) if np.size(a) else 0.0


def ratio(ours, bf16, f32, what):
    """Error over drift (module docstring), printed."""
    err = _max(_f32(ours) - _f32(bf16))
    drift = _max(_f32(bf16) - _f32(f32))
    print('%s: error %.4g, drift %.4g, ratio %.3f' % (what, err, drift,
                                                     err / drift))
    return err / drift


def within_ulp(ours, ref, what, frac):
    """Each element within one bfloat16 ulp of eve_tpu's, and at most
    ``frac`` of them off at all."""
    ours, ref = _f32(ours), _f32(ref)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    off = ours != ref
    assert (np.abs(ours - ref) <= ulp).all(), what
    assert off.mean() <= frac, (what, off.mean())


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine'])
def test_instance_norm_matches_eve_tpu(affine):
    rng = np.random.RandomState(0)
    x = (2 * rng.normal(size=(4, 9, 16, 32)) +
         3 * rng.normal(size=(4, 1, 1, 32))).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    b = (0.1 * rng.normal(size=32)).astype(np.float32)
    norm = tlayers.InstanceNorm(32, affine=affine)
    if affine:
        norm.load_state_dict({'weight': torch.from_numpy(w),
                              'bias': torch.from_numpy(b)})
    wb = (jnp.asarray(w), jnp.asarray(b)) if affine else (None, None)
    for shape in ((9, 16), (1, 1)):
        xs = jnp.asarray(x[:, :shape[0], :shape[1]]).astype(jnp.bfloat16)
        ref = jit_bf16(lambda a: jlayers.instance_norm(a, *wb), xs)(xs)
        with torch.no_grad():
            ours = norm(_nchw(xs, torch.bfloat16))
        assert ours.dtype == torch.bfloat16
        if shape == (1, 1):
            # 0, then the bias; eve_tpu leaves rounding noise here.
            want = np.broadcast_to(b[:, None, None] if affine else 0.0,
                                   ours.shape)
            np.testing.assert_array_equal(
                ours.float().numpy(),
                torch.from_numpy(np.ascontiguousarray(want)).bfloat16()
                .float().numpy())
            print('1x1: eve_tpu leaves up to %g' % _max(
                _f32(ref) - (b if affine else 0.0)))
        else:
            within_ulp(ours.float().numpy(), _to_nchw(ref), 'instance norm',
                       frac=0.01)


def test_conv_resize_and_leaky_relu_match_eve_tpu():
    """The convolution with its bias added after it (within an ulp), the
    resize as two contractions and the bfloat16 slope (bitwise)."""
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.normal(size=(2, 9, 16, 24)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    conv = jlayers.Conv(40, 3, 1, 1)
    params = _perturb(conv.init(jax.random.PRNGKey(0), x)['params'], rng)
    ref = jit_bf16(lambda p, a: conv.apply({'params': p}, a), params, x)(
        params, x)
    ours = _load(tlayers.Conv2d(24, 40, 3, 1, 1), {
        'weight': np.transpose(params['kernel'], (3, 2, 0, 1)),
        'bias': params['bias']})
    with torch.no_grad():
        got = ours(_nchw(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and ours.weight.dtype == torch.float32
    within_ulp(got.float().numpy(), _to_nchw(ref), 'conv', frac=1e-3)
    for out_hw in ((18, 32), (36, 64)):
        ref = jit_bf16(lambda a: jlayers.resize_bilinear(a, out_hw), x)(x)
        got = tlayers.resize_bilinear(_nchw(x, torch.bfloat16), out_hw)
        np.testing.assert_array_equal(got.float().numpy(), _to_nchw(ref))
    ref = jit_bf16(jlayers.leaky_relu, x)(x)
    got = tlayers.LeakyReLU(0.01)(_nchw(x, torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), _to_nchw(ref))


# ----------------------------------------------------------------------
# Networks
# ----------------------------------------------------------------------

def test_resnet_matches_eve_tpu():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (4, EYE, EYE, 3)).astype(np.float32)
    nets = {dt: jresnet.ResNet18IN(num_classes=16, compute_dtype=dt)
            for dt in (jnp.float32, jnp.bfloat16)}
    params = _perturb(jax.jit(nets[jnp.float32].init)(
        jax.random.PRNGKey(0), jnp.asarray(x))['params'], rng)
    f32 = nets[jnp.float32].apply({'params': params}, jnp.asarray(x))
    bf16 = jit_bf16(lambda p, a: nets[jnp.bfloat16].apply({'params': p}, a),
                    params, x)(params, x)
    assert bf16.dtype == jnp.float32
    ours = _load(tresnet.ResNet18IN(num_classes=16,
                                    compute_dtype=torch.bfloat16),
                 {k[len('cnn_layers.'):]: v for k, v in
                  convert.eye_net_state_dict({'cnn': params}).items()})
    with torch.no_grad():
        got = ours(_nchw(x))
    assert got.dtype == torch.float32
    assert ratio(got.numpy(), bf16, f32, 'ResNet-18') < MODULE_RATIO


@pytest.fixture(scope='module')
def refine_nets():
    rng = np.random.RandomState(2)
    kw = dict(load_screen_content=True, rnn_type='CLSTM', num_features=8)
    nets = {dt: jrefine.RefineNet(compute_dtype=dt, **kw)
            for dt in (jnp.float32, jnp.bfloat16)}
    hm = rng.uniform(0, 1, (2, 72, 128)).astype(np.float32)
    screen = rng.uniform(0, 1, (2, 72, 128, 3)).astype(np.float32)
    params = _perturb(jax.jit(nets[jnp.float32].init)(
        jax.random.PRNGKey(2), jnp.asarray(hm), jnp.asarray(screen))[
            'params'], rng)
    params['final_2']['kernel'] *= 20.0
    ours = _load(trefine.RefineNet(compute_dtype=torch.bfloat16, **kw),
                 convert.refine_net_state_dict(params))
    return nets, params, ours, hm, screen


def test_refine_net_encode_decode_match_eve_tpu(refine_nets):
    """Each stage fed eve_tpu's own bfloat16 input to it; the drift is
    eve_tpu's float32 stage on the same input."""
    nets, params, ours, hm, screen = refine_nets

    def run(dt, method, *args):
        fn = lambda p, *a: nets[dt].apply({'params': p}, *a, method=method)
        if dt == jnp.float32:
            return jax.jit(fn)(params, *args)
        return jit_bf16(fn, params, *args)(params, *args)

    x = run(jnp.bfloat16, 'assemble_input', hm, screen)
    assert x.dtype == jnp.bfloat16
    with torch.no_grad():
        t_x = ours.assemble_input(torch.from_numpy(hm),
                                  _nchw(screen))
        assert t_x.dtype == torch.bfloat16
        np.testing.assert_array_equal(t_x.float().numpy(), _to_nchw(x))
        bott, skips = run(jnp.bfloat16, 'encode', x)
        bott32, skips32 = run(jnp.float32, 'encode', jnp.asarray(_f32(x)))
        t_bott, t_skips = ours.encode(_nchw(x, torch.bfloat16))
        assert t_bott.dtype == torch.bfloat16
        assert ratio(t_bott.float().numpy(), _to_nchw(bott),
                     _to_nchw(bott32), 'encoder') < MODULE_RATIO
        for t_skip, skip, skip32 in zip(t_skips, skips, skips32):
            assert ratio(t_skip.float().numpy(), _to_nchw(skip),
                         _to_nchw(skip32), 'skip') < MODULE_RATIO
        final = run(jnp.bfloat16, 'decode', bott, skips)
        final32 = run(jnp.float32, 'decode', jnp.asarray(_f32(bott)),
                      [jnp.asarray(_f32(s)) for s in skips])
        t_final = ours.decode(_nchw(bott, torch.bfloat16),
                              [_nchw(s, torch.bfloat16) for s in skips])
    assert t_final.dtype == torch.float32
    assert float(np.asarray(final).std()) > 1e-3
    assert ratio(t_final.numpy(), final, final32, 'decoder') < MODULE_RATIO


def test_clstm_step_matches_eve_tpu():
    """One step with bfloat16 input and (h, c): bfloat16 out, within two
    ulps of each output's largest element (the module docstring)."""
    rng = np.random.RandomState(3)
    x, h, c = (jnp.asarray(rng.normal(size=(2, 5, 8, 16)).astype(
        np.float32)).astype(jnp.bfloat16) for _ in range(3))
    cell = jcells.ConvLSTMCell(16)
    params = _perturb(cell.init(jax.random.PRNGKey(3), x, (h, c))['params'],
                      rng)
    step = lambda p, a, s: cell.apply({'params': p}, a, s)
    want = jit_bf16(step, params, x, (h, c))(params, x, (h, c))
    want32 = jax.jit(step)(params, *jax.tree.map(
        lambda a: jnp.asarray(_f32(a)), (x, (h, c))))
    ours = _load(tcells.ConvLSTMCell(16, 16), {
        'gates.weight': np.transpose(params['gates']['kernel'], (3, 2, 0, 1)),
        'gates.bias': params['gates']['bias']})
    with torch.no_grad():
        got = ours(_nchw(x, torch.bfloat16),
                   (_nchw(h, torch.bfloat16), _nchw(c, torch.bfloat16)))
    for what, g, w, w32 in zip(('output', 'h', 'c'), jax.tree.leaves(got),
                               jax.tree.leaves(want), jax.tree.leaves(want32)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        ratio(g.float().numpy(), _to_nchw(w), _to_nchw(w32), 'CLSTM ' + what)
        ulp = 2.0 ** (np.floor(np.log2(_max(w))) - 7)
        np.testing.assert_allclose(g.float().numpy(), _to_nchw(w), rtol=0,
                                   atol=2 * ulp, err_msg=what)


# ----------------------------------------------------------------------
# The whole forward
# ----------------------------------------------------------------------

def _specs(dtype):
    DefaultConfig._reset_instance_for_testing()
    try:
        jc = DefaultConfig()
        jc.import_json(CONFIG)
        jc.import_dict({'tpu_compute_dtype': dtype})
        jspec = jeve.EveSpec.from_config(jc)
    finally:
        DefaultConfig._reset_instance_for_testing()
    tc = tconfig.Config()
    tc.import_json(CONFIG)
    tc.import_dict({'tpu_compute_dtype': dtype})
    return jspec, teve.EveSpec.from_config(tc)


@pytest.fixture(scope='module')
def specs():
    return {dt: _specs(dt) for dt in ('float32', 'bfloat16')}


@pytest.fixture(scope='module')
def params(specs):
    tree = jax.jit(functools.partial(jeve.init_params,
                                     specs['float32'][0]))(
        jax.random.PRNGKey(0))
    tree = _perturb(tree, np.random.RandomState(0))
    tree['refine_net']['final_2']['kernel'] *= 10.0
    # A live pupil head: most of its ReLU's inputs positive.
    tree['eye_net']['fc_to_pupil_2']['bias'] += 1.0
    return tree


@pytest.fixture(scope='module')
def model(specs, params):
    return teve.build_model(specs['bfloat16'][1],
                            convert.eve_state_dict(params), 'cpu')


@pytest.fixture(scope='module')
def model32(specs, params):
    return teve.build_model(specs['float32'][1],
                            convert.eve_state_dict(params), 'cpu')


STREAM_KEYS = ('PoG_px_initial', 'PoG_px_final', 'g_final',
               'left_pupil_size')


def assert_chunks_equal_clip(chunks, whole, whole32, what):
    """Chunk outputs, concatenated over time, against one forward over the
    clip: within the clip's bfloat16-vs-float32 drift (module docstring)."""
    for key in STREAM_KEYS:
        got = np.concatenate([np.asarray(c[key]) for c in chunks], axis=1)
        assert ratio(got, whole[key].numpy(), whole32[key].numpy(),
                     '%s %s' % (what, key)) < FRAME_RATIO, key


def _batch(seed, frame_dtype=np.uint8, B=2, T=3):
    return make_synthetic_batch(np.random.RandomState(seed), batch_size=B,
                                sequence_len=T, eyes_size=EYE,
                                frame_dtype=frame_dtype)


def _port_forward(model, batch, **kw):
    with torch.inference_mode():
        return model(teve.batch_to_tensors(batch, 'cpu'),
                     output_predictions=True, **kw)


@pytest.mark.parametrize('frame_dtype', [np.uint8, np.float32],
                         ids=['uint8', 'float32'])
def test_forward_matches_eve_tpu(specs, params, model, frame_dtype):
    def forward(spec):
        return lambda p, b: jeve.forward(spec, p, b, training=False,
                                         output_predictions=True)

    first = _batch(SEEDS[0], frame_dtype)
    f32 = jax.jit(forward(specs['float32'][0]))
    bf16 = jit_bf16(forward(specs['bfloat16'][0]), params, first)
    errs, drifts = {}, {}
    for seed in SEEDS:
        batch = _batch(seed, frame_dtype)
        ref32 = {k: np.asarray(v) for k, v in f32(params, batch).items()}
        ref16 = {k: np.asarray(v) for k, v in bf16(params, batch).items()}
        ours = _port_forward(model, batch)
        assert set(ours) == set(ref16)
        for k, want in ref16.items():
            got = ours[k].numpy()
            assert got.dtype == want.dtype, k
            if want.dtype == bool:
                np.testing.assert_array_equal(got, want, err_msg=k)
                continue
            errs.setdefault(k, []).append(_f32(got) - want)
            drifts.setdefault(k, []).append(want - _f32(ref32[k]))
    assert np.ptp(ref16['PoG_px_final']) > 1.0      # the heatmap head is live
    assert _max(ref16['left_pupil_size']) > 0.1     # and the pupil head
    for k in sorted(errs):
        err = max(_max(e) for e in errs[k])
        drift = max(_max(d) for d in drifts[k])
        if drift == 0.0:
            # Labels and geometry: float32 on both sides.
            np.testing.assert_allclose(
                np.concatenate([np.ravel(e) for e in errs[k]]), 0.0,
                atol=1e-4 * max(_max(ref16[k]), 1.0), err_msg=k)
            continue
        limit = FRAME_RATIO if np.ndim(ref16[k]) else SCALAR_RATIO
        print('%-36s error %.4g, drift %.4g, ratio %.3f (limit %g)'
              % (k, err, drift, err / drift, limit))
        assert err < limit * drift, (k, err, drift)


def _hooked(model):
    """Forward hooks recording the input type of every convolution of the
    ResNet and of RefineNet, and of each EyeNet cell."""
    seen = {'conv': set(), 'cell': set()}
    handles = []
    for root in (model.eye_net.cnn_layers, model.refine_net):
        for m in root.modules():
            if isinstance(m, torch.nn.Conv2d):
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args: seen['conv'].add(args[0].dtype)))
    for cell in model.eye_net.rnn_cells:
        handles.append(cell.register_forward_pre_hook(
            lambda mod, args: seen['cell'].update(
                a.dtype for a in args if isinstance(a, torch.Tensor))))
    return seen, handles


@pytest.mark.parametrize('dtype', ['bfloat16', 'float16', 'float32'])
def test_compute_types(specs, params, dtype):
    """bfloat16 convolutions and a float32 GRU under 'bfloat16'; float32
    throughout under any other value, as eve_tpu's ``EveSpec.dtype``."""
    spec = dataclasses.replace(specs['float32'][1], compute_dtype=dtype)
    want = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    assert spec.dtype == want
    assert (jeve.EveSpec(compute_dtype=dtype).dtype == jnp.bfloat16) == (
        dtype == 'bfloat16')
    model = teve.build_model(spec, convert.eve_state_dict(params), 'cpu')
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    seen, handles = _hooked(model)
    out = _port_forward(model, _batch(5))
    for h in handles:
        h.remove()
    assert seen == {'conv': {want}, 'cell': {torch.float32}}, seen
    for k in ('PoG_px_initial', 'PoG_px_final', 'PoG_cm_final', 'g_final',
              'full_loss', 'loss_ce_heatmap_final'):
        assert out[k].dtype == torch.float32, k
    with torch.inference_mode():
        out = model(teve.batch_to_tensors(_batch(5), 'cpu'),
                    create_images=True)
    assert out['final_heatmap'].dtype == torch.float32
    states = teve.init_stream_state(spec, 2)
    assert {s.dtype for s in states['eye_left']} == {torch.float32}
    assert {s.dtype for s in states['refine'][0]} == {want}


# ----------------------------------------------------------------------
# Streaming and serving
# ----------------------------------------------------------------------

def test_streaming_two_chunks_equal_one_clip(model, model32):
    batch = _batch(2, T=3)
    whole = _port_forward(model, batch)
    first = _port_forward(model, {k: v[:, :2] for k, v in batch.items()},
                          return_states=True)
    assert {s.dtype for s in first['states']['refine'][0]} == {
        torch.bfloat16}
    second = _port_forward(model, {k: v[:, 2:] for k, v in batch.items()},
                           initial_states=first['states'],
                           return_states=True)
    assert_chunks_equal_clip([first, second], whole,
                             _port_forward(model32, batch), 'streamed')


def test_serving_engine_serves_bfloat16_sessions(specs, params, model,
                                                 model32):
    """Three chunks of one session through the engine (host states kept
    in float32, cast on the device) equal one forward over the clip."""
    batch = _batch(4, B=1, T=6)
    batch = {k: v for k, v in batch.items()
             if not k.endswith(('_tobii', '_tobii_validity', '_p',
                                '_p_validity'))}
    engine = ServingEngine(specs['bfloat16'][1],
                           convert.eve_state_dict(params), device='cpu',
                           max_batch=2, max_delay_ms=1.0)
    try:
        sid = engine.open_session()
        outs = [engine.infer({k: v[0, 2 * c:2 * c + 2]
                              for k, v in batch.items()}, session_id=sid)
                for c in range(3)]
        state = engine._sessions[sid].state
    finally:
        engine.stop()
    assert state['refine'][0][0].dtype == np.float32
    assert_chunks_equal_clip([{k: v[None] for k, v in o.items()}
                              for o in outs], _port_forward(model, batch),
                             _port_forward(model32, batch), 'served')


def test_infer_iterator_streams_bfloat16_states(model, model32):
    batch = _batch(6, B=1, T=4)
    chunks = [{k: v[:, 2 * c:2 * c + 2] for k, v in batch.items()}
              for c in range(2)]
    seen = []
    handle = model.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append(
            kwargs['initial_states']['refine'][0][0].dtype),
        with_kwargs=True)
    try:
        outs = [o for _, _, o in infer.iterator(model, chunks,
                                                 create_images=False,
                                                 streaming=True)]
    finally:
        handle.remove()
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert_chunks_equal_clip(outs, _port_forward(model, batch),
                             _port_forward(model32, batch), 'iterated')
