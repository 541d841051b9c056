"""The fused instance norm + activation: its op on the CPU, and its kernel on
the card.

On the CPU (every test without a marker): ``InstanceNorm(act=...)`` equals
the norm followed by the activation module as the networks composed them
before the activation moved into the norm, bitwise, at float32 and
bfloat16; the networks' state_dict names are the reference's; the op
passes ``opcheck``, its backward is autograd's through the plain version,
and its fake implementation launches nothing; the wrapper skips the op's
dispatch only where nothing records the call; a bf16 ``Conv2d`` keeps its
casts only without autograd and while its parameters are unchanged.

Channels-last, on the CPU: the plain version on a channels-last input
gives the NCHW values within one bf16 ulp, in the input's layout; the op's
fake gives the layout its CUDA implementation writes; the layout choice
(the NHWC kernel, or the general kernel on a contiguous input) and the
NHWC kernel's tiling; every norm of each shipped configuration's bf16
forward, channels-last, at 128 px eyes and smaller, takes the NHWC kernel
unless its map is 1x1.

On the card (``cuda`` marker; skipped without one): the kernels against the
plain version at every norm of a bf16 EVE forward (channels-last: the NHWC
kernel), at each of its shapes in both layouts (NCHW: the general kernel),
at the NHWC kernel's shapes of a Codalab forward, and at the odd shapes
the general kernel takes (a 1x1 map, planes not a multiple of 8 values,
one plane, an unaligned tensor, a large plane),
where outputs may differ only by the order of a plane's float32 sums
tipping the bf16 rounding of its scale or shift; the call past the op
against the op; the gradient through the op; and the forward's launch
count.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

from eve_tpu_torch.kernels import norm_kernels as nk
from eve_tpu_torch.models import layers
from eve_tpu_torch.models.eye_net import EyeNet
from eve_tpu_torch.models.refine_net import NUM_ENC_BLOCKS, RefineNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_SLOPE = 0.010009765625
# Norms of one EVE forward: 20 in ResNet-18, 39 in RefineNet.
FORWARD_NORMS = 59
# Share of elements the kernel and the plain version may differ at.
MAX_DIFF_SHARE = 1e-3


def _seed_norm(norm, x):
    """``InstanceNorm.forward`` as it was before the activation moved into
    it (the norm alone)."""
    if x.dtype == torch.float32:
        mean = x.mean(dim=(-2, -1), keepdim=True)
        xc = x - mean
        var = (xc * xc).mean(dim=(-2, -1), keepdim=True)
        y = xc * torch.rsqrt(var + norm.eps)
        if norm.weight is not None:
            y = y * norm.weight[:, None, None] + norm.bias[:, None, None]
        return y
    if x.shape[-2] * x.shape[-1] == 1:
        y = torch.zeros_like(x)
        if norm.bias is not None:
            y = y + norm.bias.to(x.dtype)[:, None, None]
        return y
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    ex2 = (xf * xf).mean(dim=(-2, -1), keepdim=True)
    scale = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + norm.eps)
    if norm.weight is not None:
        scale = scale * norm.weight[:, None, None]
    shift = -mean * scale
    if norm.bias is not None:
        shift = shift + norm.bias[:, None, None]
    return x * scale.to(x.dtype) + shift.to(x.dtype)


# The activation modules the networks put after a norm.
SEED_ACTS = {None: nn.Identity(), 'relu': nn.ReLU(),
             'leaky': layers.LeakyReLU(0.01)}


def _inputs(shape, seed, dtype=torch.float32, device='cpu'):
    """Values with a per-plane offset and spread, as a convolution's output
    has, in ``dtype``."""
    rng = np.random.RandomState(seed)
    n, c = shape[:2]
    x = (rng.normal(size=shape) * rng.uniform(0.2, 3.0, (n, c, 1, 1))
         + rng.normal(size=(n, c, 1, 1)) * 2.0)
    return torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                     dtype=dtype)


def _affine(c, seed, device='cpu'):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((1 + 0.2 * rng.normal(size=c)).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.normal(size=c)).astype(np.float32))
    return w.to(device), b.to(device)


def _norm(c, affine, act, seed=0, device='cpu'):
    norm = layers.InstanceNorm(c, affine=affine, act=act).to(device)
    if affine:
        w, b = _affine(c, seed, device)
        norm.load_state_dict({'weight': w, 'bias': b})
    return norm


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('act', [None, 'relu', 'leaky'],
                         ids=['none', 'relu', 'leaky'])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
def test_norm_with_act_equals_norm_then_activation(dtype, affine, act):
    norm = _norm(6, affine, act, seed=1)
    for shape in ((3, 6, 9, 16), (2, 6, 5, 8), (2, 6, 1, 1)):
        x = _inputs(shape, seed=sum(shape), dtype=dtype)
        with torch.no_grad():
            ours = norm(x)
            want = SEED_ACTS[act](_seed_norm(norm, x))
        assert ours.dtype == dtype
        assert torch.equal(ours, want), (shape, act)


def _preact_keys(prefix, skip):
    keys = ['%slayers.%d.%s' % (prefix, i, p)
            for i in (0, 2, 3, 5) for p in ('weight', 'bias')]
    if skip:
        keys += ['%sskip_layer.%d.%s' % (prefix, i, p)
                 for i in (0, 2) for p in ('weight', 'bias')]
    return keys


def test_state_dict_names_are_the_reference_ones():
    """RefineNet as the reference nests it (``initial.0/1/3``, each block's
    ``layers.0/2/3/5`` and ``skip_layer.0/2``, ``final.0/2``), the bf16
    benchmark's scaled key ``network.*.layers.5.weight`` among them; the
    ResNet-18 of EyeNet (affine-free norms) with torchvision's names."""
    model = RefineNet()
    want = ['initial.%d.%s' % (i, p) for i in (0, 1, 3)
            for p in ('weight', 'bias')]
    want += ['final.%d.%s' % (i, p) for i in (0, 2)
             for p in ('weight', 'bias')]
    for k in range(5):
        prefix = 'network.' + 'between_module.' * k
        for i in range(NUM_ENC_BLOCKS[k]):
            want += _preact_keys('%sencoder_blocks.%d.' % (prefix, i), i == 0)
        want += _preact_keys('%sdecoder_blocks.0.' % prefix, True)
    cells = [k for k in model.state_dict() if '.rnn_cells.' in k]
    assert cells
    assert sorted(model.state_dict()) == sorted(want + cells)
    assert 'network.encoder_blocks.0.layers.5.weight' in want

    want = ['cnn_layers.conv1.weight', 'cnn_layers.fc.weight',
            'cnn_layers.fc.bias']
    for stage in range(1, 5):
        for block in (0, 1):
            want += ['cnn_layers.layer%d.%d.conv%d.weight' % (stage, block, i)
                     for i in (1, 2)]
        if stage > 1:
            want.append('cnn_layers.layer%d.0.downsample.0.weight' % stage)
    got = [k for k in EyeNet().state_dict() if k.startswith('cnn_layers.')]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize('act', ['none', 'relu', 'leaky'])
def test_op_passes_opcheck(act):
    """Schema, fake implementation, autograd registration and AOTAutograd,
    with and without the affine parameters."""
    x = _inputs((2, 4, 6, 8), 3, torch.bfloat16).requires_grad_(True)
    w, b = _affine(4, 4)
    op = torch.ops.eve_tpu_torch.instance_norm.default
    torch.library.opcheck(op, (x, w.requires_grad_(True),
                               b.requires_grad_(True), 1e-5, act, BF16_SLOPE))
    torch.library.opcheck(op, (x, None, None, 1e-5, act, BF16_SLOPE))


def _grads(y, inputs, g):
    """Gradients of ``y`` to ``inputs``, zeros where none flows (a 1x1 map
    without a bias gives a constant)."""
    if not y.requires_grad:
        return [torch.zeros_like(t) for t in inputs]
    return torch.autograd.grad(y, inputs, g, allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize('act', ['none', 'relu', 'leaky'])
def test_op_gradients_equal_the_plain_version(act):
    """The op's backward (``plain_backward``) equals autograd of the plain
    version bitwise, to the input, weight and bias, also at a map of one
    row, at RefineNet's largest map and at a constant plane (its variance
    clamped at 0); at a 1x1 map the input gets zeros, with or without the
    affine parameters (without, the norm's output is a constant), and a
    loss through the op still reaches what lies before it."""
    for shape in ((2, 4, 6, 8), (2, 4, 1, 7), (1, 4, 72, 128), (2, 4, 1, 1)):
        x0 = _inputs(shape, 5, torch.bfloat16)
        x0[0, 1] = 1.5
        w0, b0 = _affine(4, 6)
        g = _inputs(shape, 7, torch.bfloat16)
        for affine in (True, False):
            grads = []
            for fn in (nk.instance_norm, nk.instance_norm_plain):
                x, w, b = (t.clone().requires_grad_(True)
                           for t in (x0, w0, b0))
                params = (w, b) if affine else (None, None)
                y = fn(x, *params, 1e-5, act, BF16_SLOPE)
                grads.append(_grads(y, (x,) + ((w, b) if affine else ()),
                                    g))
            for ours, want in zip(*grads):
                assert torch.equal(ours, want), (shape, affine)
    # A 1x1 map without a bias inside a network: the loss's backward
    # passes the op (zeros) and reaches the convolution before it.
    conv = nn.Conv2d(3, 4, 1)
    x = torch.randn(2, 3, 1, 1)
    y = conv(x).bfloat16()
    (nk.instance_norm(y, act=act).float().sum() + y.float().sum()).backward()
    assert conv.weight.grad is not None


@pytest.mark.parametrize('act', ['none', 'relu', 'leaky'])
def test_op_passes_opcheck_channels_last(act):
    """The same on a channels-last input the NHWC kernel takes: the CPU
    implementation and the fake give its layout."""
    x = _inputs((2, 16, 6, 8), 23, torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    w, b = _affine(16, 24)
    op = torch.ops.eve_tpu_torch.instance_norm.default
    torch.library.opcheck(op, (x, w.requires_grad_(True),
                               b.requires_grad_(True), 1e-5, act, BF16_SLOPE))


@pytest.mark.parametrize('act', ['none', 'relu', 'leaky'])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine'])
def test_channels_last_plain_matches_nchw(affine, act):
    """On a channels-last bf16 input the norm gives the NCHW input's values
    within one bf16 ulp (its float32 sums in another order), channels-last,
    at the shapes of both networks (an odd channel count and a 1x1 map
    too)."""
    for i, shape in enumerate(((3, 64, 16, 16), (2, 16, 9, 16),
                               (2, 256, 5, 8), (2, 6, 7, 9), (2, 8, 1, 1))):
        x = _inputs(shape, 40 + i, torch.bfloat16)
        w, b = _affine(shape[1], 50 + i)
        params = (w, b) if affine else (None, None)
        want = nk.instance_norm(x, *params, 1e-5, act, BF16_SLOPE)
        xl = x.contiguous(memory_format=torch.channels_last)
        got = nk.instance_norm(xl, *params, 1e-5, act, BF16_SLOPE)
        assert got.stride() == torch.empty_like(
            xl, memory_format=nk.out_format(xl)).stride(), shape
        ulps = (got.contiguous().view(torch.int16).int()
                - want.view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1, shape


@pytest.mark.parametrize('case,want', [
    ('nchw', 'nchw'), ('channels_last', 'nhwc'),
    ('channels_last_odd_channels', 'nchw'), ('channels_last_1x1', 'nchw'),
    ('sliced', 'nchw'), ('three_dims', 'nchw'),
    ('channels_last_too_large', 'nchw')])
def test_layout_choice(case, want):
    """Channels-last of a shape the NHWC kernel tiles: the NHWC kernel;
    anything else (contiguous, channels-last with a channel count the
    kernel does not take, a 1x1 map, a slice, a map too large for a
    cluster): the general kernel, on a contiguous copy where the input is
    not contiguous."""
    x = {
        'nchw': lambda: torch.empty(2, 16, 4, 4),
        'channels_last': lambda: torch.empty(2, 16, 4, 4).contiguous(
            memory_format=torch.channels_last),
        'channels_last_odd_channels': lambda: torch.empty(2, 6, 4, 4)
        .contiguous(memory_format=torch.channels_last),
        'channels_last_1x1': lambda: torch.empty(2, 16, 1, 1).contiguous(
            memory_format=torch.channels_last),
        'sliced': lambda: torch.empty(2, 16, 4, 8, dtype=torch.bfloat16)[
            ..., ::2],
        'three_dims': lambda: torch.empty(16, 4, 4),
        'channels_last_too_large': lambda: torch.empty(
            1, 16, 300, 200).contiguous(memory_format=torch.channels_last),
    }[case]().bfloat16()
    assert nk.layout(x) == want
    fmt = nk.out_format(x)
    assert fmt == (torch.channels_last if want == 'nhwc'
                   else torch.contiguous_format)


@pytest.mark.parametrize('c,hw,want', [
    (64, 4096, (32, 4, 256, 4)),     # the EyeNet stem, 64x64: a cluster
    (64, 1024, (32, 1, 256, 4)),     # layer1, 32x32: a 32-channel tile
    (128, 256, (128, 1, 256, 1)),    # layer2, 16x16
    (256, 64, (256, 1, 64, 1)),      # layer3, 8x8
    (512, 16, (256, 1, 16, 1)),      # layer4, 4x4: two tiles
    (16, 9216, (16, 5, 232, 8)),     # RefineNet level 0, 72x128
    (64, 9216, (32, 8, 232, 5)),     # its decoder input
    (32, 2304, (32, 3, 256, 3)),     # level 1, 36x64
    (128, 144, (128, 1, 144, 1)),    # level 3, 9x16
    (256, 40, (256, 1, 40, 1)),      # level 4, 5x8
    (24, 63, (8, 1, 64, 1)),         # odd: 8-channel tiles
    (6, 64, None), (16, 1, None), (16, 60000, None),
])
def test_nhwc_launch(c, hw, want):
    got = nk.nhwc_launch(c, hw)
    assert got == want
    if got:
        tile, cluster, box_rows, boxes = got
        rows = box_rows * boxes
        assert c % tile == 0 and box_rows % 8 == 0
        assert box_rows <= nk.MAX_BOX_ROWS and boxes <= nk.MAX_BOXES
        assert cluster <= nk.MAX_CLUSTER
        assert cluster == 1 or tile <= nk.MAX_CLUSTER_TILE
        assert (cluster - 1) * rows < hw <= cluster * rows
        assert rows * tile * 2 <= nk.MAX_SLAB_BYTES


def test_fake_op_gives_shapes_and_launches_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    nk.reset_launch_counts()
    with FakeTensorMode():
        y = nk.instance_norm(torch.empty((4, 16, 72, 128),
                                         dtype=torch.bfloat16),
                             torch.empty(16), torch.empty(16), act='leaky',
                             slope=BF16_SLOPE)
    assert y.shape == (4, 16, 72, 128) and y.dtype == torch.bfloat16
    assert y.is_contiguous()
    with FakeTensorMode():
        y = nk.instance_norm(torch.empty((4, 16, 72, 128),
                                         dtype=torch.bfloat16).contiguous(
                                             memory_format=torch.channels_last),
                             act='relu')
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert not y.is_contiguous()
    assert nk.LAUNCHES == {'instance_norm': 0}


def test_cpu_norms_launch_nothing_and_other_devices_are_refused():
    nk.reset_launch_counts()
    norm = _norm(4, True, 'relu')
    with torch.no_grad():
        norm(_inputs((2, 4, 8, 8), 8, torch.bfloat16))
    assert nk.LAUNCHES == {'instance_norm': 0}
    with pytest.raises(ValueError, match='CPU or CUDA'):
        nk.instance_norm(torch.empty((1, 4, 8, 8), dtype=torch.bfloat16,
                                     device='meta'))
    with pytest.raises(ValueError, match='act'):
        layers.InstanceNorm(4, act='gelu')


# Shipped configurations: (config file, overrides), and the eye sizes of
# each (128 px and the smaller ones the parity tests use).
MODEL_CONFIGS = {
    'eye_net': ('eye_net.json', {}),
    'refine_net': ('refine_net.json', {}),
    'patchify': ('refine_net.json', {'tpu_native_arch': True,
                                     'tpu_native_stem': 'patchify'}),
    'patchify8': ('refine_net.json', {'tpu_native_arch': True,
                                      'tpu_native_stem': 'patchify8'}),
}
MODEL_EYES = {'eye_net': (128, 64, 48, 32), 'refine_net': (128, 64, 48, 32),
              'patchify': (128, 64, 48, 32), 'patchify8': (128, 72, 64, 48)}


@pytest.mark.parametrize('name,eyes', [
    (name, eyes) for name in MODEL_CONFIGS for eyes in MODEL_EYES[name]])
def test_model_norms_take_the_nhwc_kernel(name, eyes, monkeypatch):
    """Every norm input of a bf16 forward (B = 1, T = 1, seeded weights)
    of a shipped configuration, channels-last as on the card: the NHWC
    kernel tiles each map of more than one value, so only 1x1 maps (the
    last ResNet-18 stage at small eyes) take the general kernel."""
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    from eve_tpu_torch.models import eve as eve_lib

    path, overrides = MODEL_CONFIGS[name]
    config = Config()
    config.import_json(os.path.join(ROOT, 'configs', path))
    config.import_dict(dict(overrides, tpu_compute_dtype='bfloat16',
                            eyes_size=[eyes, eyes]))
    spec = eve_lib.EveSpec.from_config(config)
    model = eve_lib.init_model(spec, torch.Generator().manual_seed(0),
                               device='cpu')
    batch = make_synthetic_batch(np.random.RandomState(0), batch_size=1,
                                 sequence_len=1, eyes_size=eyes,
                                 frame_dtype=np.uint8)
    monkeypatch.setattr(layers, 'runs_channels_last',
                        lambda dtype, device: dtype == torch.bfloat16)
    seen = []
    hooks = [m.register_forward_hook(
                 lambda mod, args, out, where=where: seen.append(
                     (where, args[0])))
             for where, m in model.named_modules()
             if isinstance(m, layers.InstanceNorm)]
    try:
        with torch.inference_mode():
            model(eve_lib.batch_to_tensors(batch, 'cpu'),
                  output_predictions=True)
    finally:
        for h in hooks:
            h.remove()
    assert seen
    for where, x in seen:
        c, h, w = x.shape[1:]
        assert x.dtype == torch.bfloat16
        if h * w > 1:
            assert nk.nhwc_launch(c, h * w) is not None, (where, x.shape)
            assert nk.layout(x) == 'nhwc', (where, x.shape)
        else:
            assert '.layer4.' in where, (where, x.shape)
            assert nk.layout(x) == 'nchw', (where, x.shape)


class _AnyMode(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _eager_case(case, monkeypatch):
    """``nk.eager`` on an input and the affine parameters, as ``case``
    sets them up."""
    x = _inputs((2, 4, 8, 8), 21, torch.bfloat16)
    w, b = (nn.Parameter(t, requires_grad=False) for t in _affine(4, 22))
    if case == 'no_grad':
        w.requires_grad_(True)
        with torch.no_grad():
            return nk.eager(x, w, b)
    if case == 'grad_on_nothing_requires_it':
        return nk.eager(x, w, b)
    if case == 'input_requires_grad':
        return nk.eager(x.requires_grad_(True), w, b)
    if case == 'weight_requires_grad':
        return nk.eager(x, w.requires_grad_(True), b)
    if case == 'fake_tensors':
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode() as mode:
            return nk.eager(mode.from_tensor(x), None, None)
    if case == 'dispatch_mode':
        with _AnyMode():
            return nk.eager(x, None, None)
    monkeypatch.setattr(torch.compiler, 'is_compiling', lambda: True)
    return nk.eager(x, w, b)


@pytest.mark.parametrize('case,want', [
    ('no_grad', True), ('grad_on_nothing_requires_it', True),
    ('input_requires_grad', False), ('weight_requires_grad', False),
    ('fake_tensors', False), ('dispatch_mode', False), ('compiling', False),
])
def test_eager_holds_where_nothing_records_the_call(case, want,
                                                     monkeypatch):
    """Where ``eager`` holds, a CUDA call skips the op's dispatch; where
    autograd, tracing or a dispatch mode would record it, it does not."""
    assert nk.eager(*()) is True
    assert _eager_case(case, monkeypatch) is want


def _conv_pair(bias, seed=31):
    torch.manual_seed(seed)
    conv = layers.Conv2d(3, 5, 3, padding=1, bias=bias)
    ref = nn.Conv2d(3, 5, 3, padding=1, bias=bias)
    ref.load_state_dict(conv.state_dict())
    return conv, ref


def _conv_ref(ref, x):
    """The bf16 convolution with its casts made at the call."""
    y = ref._conv_forward(x, ref.weight.to(x.dtype), None)
    return y if ref.bias is None else y + ref.bias.to(x.dtype)[:, None, None]


@pytest.mark.parametrize('bias', [True, False], ids=['bias', 'no_bias'])
@pytest.mark.parametrize('mode', ['no_grad', 'inference_mode'])
def test_conv_casts_are_kept_while_the_parameters_are_unchanged(mode, bias):
    """Without autograd a bf16 ``Conv2d`` casts its parameters once and
    keeps the casts until a parameter changes in place or is loaded; each
    output equals the convolution with casts made at the call, bitwise."""
    conv, ref = _conv_pair(bias)
    x = _inputs((2, 3, 8, 8), 32, torch.bfloat16)
    ctx = torch.no_grad if mode == 'no_grad' else torch.inference_mode
    with ctx():
        assert torch.equal(conv(x), _conv_ref(ref, x))
        casts = conv._cast_cache[2]
        assert torch.equal(conv(x), _conv_ref(ref, x))
        assert conv._cast_cache[2] is casts
    with torch.no_grad():
        conv.weight.mul_(2)
        ref.weight.mul_(2)
    with ctx():
        assert torch.equal(conv(x), _conv_ref(ref, x))
        assert conv._cast_cache[2] is not casts
        casts = conv._cast_cache[2]
    state = {k: v + 1 for k, v in conv.state_dict().items()}
    conv.load_state_dict(state)
    ref.load_state_dict(state)
    with ctx():
        assert torch.equal(conv(x), _conv_ref(ref, x))
        assert conv._cast_cache[2] is not casts


def test_conv_casts_follow_a_new_storage():
    """A parameter given new data (as ``Module.to`` does) is cast anew."""
    conv, ref = _conv_pair(True)
    x = _inputs((2, 3, 8, 8), 33, torch.bfloat16)
    with torch.no_grad():
        conv(x)
        new = torch.randn_like(conv.weight)
        conv.weight.data = new
        ref.weight.data = new.clone()
        assert torch.equal(conv(x), _conv_ref(ref, x))


def test_conv_casts_under_autograd_are_made_at_each_call():
    """With autograd the casts are in the graph: no cache is made, and a
    cache made before (in inference mode) does not reach the graph, whose
    gradients equal the plain convolution's."""
    conv, ref = _conv_pair(True)
    x = _inputs((2, 3, 8, 8), 34, torch.bfloat16)
    g = _inputs((2, 5, 8, 8), 35, torch.bfloat16)
    conv(x).backward(g)
    assert '_cast_cache' not in conv.__dict__
    with torch.inference_mode():
        conv(x)
    conv.zero_grad()
    y = conv(x)
    y.backward(g)
    _conv_ref(ref, x).backward(g)
    assert torch.equal(conv.weight.grad, ref.weight.grad)
    assert torch.equal(conv.bias.grad, ref.bias.grad)


def test_float32_conv_keeps_no_casts():
    conv, ref = _conv_pair(True)
    x = _inputs((2, 3, 8, 8), 36, torch.float32)
    with torch.no_grad():
        assert torch.equal(conv(x), ref(x))
    assert '_cast_cache' not in conv.__dict__


def test_mean_factor_is_the_cards_mean():
    assert nk.mean_factor(4, 64) == 1 / 64
    assert nk.mean_factor(3, 40) == float(np.float32(3) / np.float32(120))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _require_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (chip_smoke.py runs the kernel there)')


def _neighbours(v):
    """``v`` (a 0-dim bf16 tensor) and the bf16 values one step either
    side of it."""
    bits = v.view(torch.int16)
    return [(bits + d).view(torch.bfloat16) for d in (0, -1, 1)]


def _compare(x, weight, bias, act, slope=BF16_SLOPE, eps=1e-5):
    """The kernel against the plain version on ``x``: ``(elements that
    differ, elements)``. Each plane that differs must be the plain
    version's with its bf16 scale or shift (or both) one rounding step
    away, which is what another order of its float32 sums can give."""
    got = nk.instance_norm(x, weight, bias, eps, act, slope)
    want = nk.instance_norm_plain(x, weight, bias, eps, act, slope)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=nk.out_format(x))
    differ = got != want
    n_diff = int(differ.sum())
    if n_diff:
        assert x.shape[-2] * x.shape[-1] > 1, 'a 1x1 map differs'
        scale, shift = nk.plain_scale_shift(x, weight, bias, eps)
        planes = differ.flatten(-2).any(-1).nonzero().tolist()
        for n, c in planes:
            explained = any(
                torch.equal(nk.activate(x[n, c] * s + h, act, slope),
                            got[n, c])
                for s in _neighbours(scale[n, c, 0, 0])
                for h in _neighbours(shift[n, c, 0, 0]))
            assert explained, ('plane (%d, %d) of %s differs by more than '
                               'a rounding of its scale or shift'
                               % (n, c, tuple(x.shape)))
    return n_diff, got.numel()


@pytest.fixture(scope='module')
def card_forward():
    """A bf16 EVE forward of ``configs/refine_net.json`` on the card at
    B = 2, T = 3 with seeded weights: the launches it counted and every
    norm's (module, input)."""
    _require_card()
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    from eve_tpu_torch.models import eve as eve_lib

    config = Config()
    config.import_json(os.path.join(ROOT, 'configs', 'refine_net.json'))
    config.import_dict({'tpu_compute_dtype': 'bfloat16'})
    spec = eve_lib.EveSpec.from_config(config)
    model = eve_lib.init_model(spec, torch.Generator().manual_seed(0),
                               device='cuda')
    batch = make_synthetic_batch(np.random.RandomState(0), batch_size=2,
                                 sequence_len=3, eyes_size=128,
                                 frame_dtype=np.uint8)
    batch = {k: v for k, v in batch.items()
             if not k.endswith(('_tobii', '_tobii_validity', '_p',
                                '_p_validity'))}
    seen = []
    hooks = [m.register_forward_hook(
                 lambda mod, args, out: seen.append((mod, args[0].clone())))
             for m in model.modules() if isinstance(m, layers.InstanceNorm)]
    nk.reset_launch_counts()
    try:
        with torch.inference_mode():
            out = model(eve_lib.batch_to_tensors(batch, 'cuda'),
                        output_predictions=True)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    assert torch.isfinite(out['PoG_px_final']).all()
    return {'launches': nk.LAUNCHES['instance_norm'], 'norms': seen}


@pytest.mark.cuda
def test_eve_forward_launches_the_kernel_at_every_norm(card_forward):
    assert len(card_forward['norms']) == FORWARD_NORMS
    assert card_forward['launches'] == FORWARD_NORMS
    n_diff = total = 0
    with torch.inference_mode():
        for norm, x in card_forward['norms']:
            assert x.dtype == torch.bfloat16 and x.is_cuda
            d, t = _compare(x, norm.weight, norm.bias, norm.act or 'none')
            n_diff, total = n_diff + d, total + t
    print('forward inputs: %d of %d elements differ (%.2e)'
          % (n_diff, total, n_diff / total))
    assert n_diff <= MAX_DIFF_SHARE * total


# The NHWC kernel's shapes in a Codalab forward, (C, H, W): EyeNet's
# stages and RefineNet's levels (its 72 x 128 maps split over a cluster).
NHWC_SHAPES = [(64, 64, 64), (64, 32, 32), (128, 16, 16), (256, 8, 8),
               (512, 4, 4), (16, 72, 128), (32, 72, 128), (64, 72, 128),
               (32, 36, 64), (64, 18, 32), (128, 9, 16), (256, 5, 8)]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(card_forward):
    """Every (C, H, W) of the forward's norms at N = 3, affine or not, each
    activation, on seeded inputs, in both layouts (NCHW: the general
    kernel), and the NHWC kernel's shapes channels-last; then the odd
    shapes, which the general kernel takes."""
    shapes = sorted({tuple(x.shape[1:]) for _, x in card_forward['norms']})
    extra = [(2, 5, 1, 1), (2, 3, 7, 9), (2, 3, 3, 3), (1, 1, 9, 16),
             (1, 1, 72, 128), (2, 4, 1, 8), (1, 2, 256, 256)]
    n_diff = total = 0
    cases = ([((3,) + s, False) for s in shapes]
             + [((3,) + s, True) for s in sorted(set(shapes)
                                                 | set(NHWC_SHAPES))]
             + [(s, False) for s in extra])
    with torch.inference_mode():
        for i, (shape, last) in enumerate(cases):
            x = _inputs(shape, 100 + i, torch.bfloat16, 'cuda')
            if last:
                x = x.contiguous(memory_format=torch.channels_last)
                assert nk.layout(x) == 'nhwc', shape
            w, b = _affine(shape[1], 200 + i, 'cuda')
            for weight, bias in ((None, None), (w, b)):
                for act in ('none', 'relu', 'leaky'):
                    d, t = _compare(x, weight, bias, act)
                    n_diff, total = n_diff + d, total + t
        # An unaligned tensor (its first value 2 bytes past an aligned
        # address).
        base = _inputs((1, 3 * 4 * 8 * 8 + 1, 1, 1), 9, torch.bfloat16,
                       'cuda').flatten()
        x = base[1:].view(3, 4, 8, 8)
        assert x.data_ptr() % 16
        w, b = _affine(4, 10, 'cuda')
        for act in ('none', 'relu', 'leaky'):
            d, t = _compare(x, w, b, act)
            n_diff, total = n_diff + d, total + t
    print('%d shapes: %d of %d elements differ (%.2e)'
          % (len(cases) + 1, n_diff, total, n_diff / total))
    assert n_diff <= MAX_DIFF_SHARE * total


@pytest.mark.cuda
def test_nhwc_kernel_runs_on_each_card():
    """The NHWC kernel's shared-memory opt-in (past 48 KB) holds per card:
    the same channels-last norms on cuda:0, then on cuda:1, give the same
    values, alone and in a cluster."""
    _require_card()
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards')
    outs = []
    with torch.inference_mode():
        for card in ('cuda:0', 'cuda:1'):
            got = []
            for i, shape in enumerate([(2, 64, 32, 32), (2, 16, 72, 128)]):
                x = _inputs(shape, 300 + i, torch.bfloat16, card).contiguous(
                    memory_format=torch.channels_last)
                assert nk.layout(x) == 'nhwc'
                w, b = _affine(shape[1], 310 + i, card)
                d, t = _compare(x, w, b, 'leaky')
                assert d <= MAX_DIFF_SHARE * t
                got.append(nk.instance_norm(x, w, b, 1e-5, 'leaky',
                                            BF16_SLOPE).cpu())
            torch.cuda.synchronize(card)
            outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_direct_call_is_the_ops_launch():
    """Without autograd the wrapper launches the kernel past the op: the
    same output as the op, bitwise, and one launch counted each."""
    _require_card()
    x = _inputs((3, 64, 72, 128), 14, torch.bfloat16, 'cuda')
    w, b = _affine(64, 15, 'cuda')
    op = torch.ops.eve_tpu_torch.instance_norm
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            nk.reset_launch_counts()
            direct = nk.instance_norm(x, w, b, 1e-5, 'leaky', BF16_SLOPE)
            assert nk.LAUNCHES['instance_norm'] == 1
            via_op = op(x, w, b, 1e-5, 'leaky', BF16_SLOPE)
            assert nk.LAUNCHES['instance_norm'] == 2
        assert torch.equal(direct, via_op)


@pytest.mark.cuda
def test_op_gradient_on_card_equals_the_plain_version():
    _require_card()
    x0 = _inputs((2, 16, 72, 128), 11, torch.bfloat16, 'cuda')
    w0, b0 = _affine(16, 12, 'cuda')
    g = _inputs((2, 16, 72, 128), 13, torch.bfloat16, 'cuda')
    for act in ('none', 'relu', 'leaky'):
        grads = []
        for fn in (nk.instance_norm, nk.instance_norm_plain):
            x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
            y = fn(x, w, b, 1e-5, act, BF16_SLOPE)
            grads.append(torch.autograd.grad(y, (x, w, b), g))
        for ours, want in zip(*grads):
            assert torch.equal(ours, want), act
