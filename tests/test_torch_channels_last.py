"""The bf16 networks stored channels-last, as they run on the card.

On the card a bf16 network keeps its activations channels-last
(``layers.runs_channels_last``): cuDNN's bf16 convolutions are NHWC
kernels. The CPU runs NCHW, so these tests force the choice on the CPU
(``runs_channels_last`` patched, here only) and hold the channels-last
forward to the NCHW one: every convolution and norm keeps the layout, and
the outputs agree within one bf16 ulp at under 1% of the elements (the
suite's bf16 tolerance for a reordered float32 sum; on the CPU they agree
bitwise). Besides: the layout's pieces (the NHWC resize, the channel
concatenation, the max-pool form of the adaptive pool) against their NCHW
forms, and the entry's choice.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eve_tpu_torch.models import eve as eve_lib
from eve_tpu_torch.models import layers
from eve_tpu_torch.models.eye_net import EyeNet
from eve_tpu_torch.models.refine_net import LEVEL_SHAPES, RefineNet

CL = torch.channels_last
# Share of elements one bf16 ulp apart that a reordered sum may leave.
MAX_ULP_SHARE = 1e-2


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def channels_last(monkeypatch):
    """The card's choice, on the CPU: bf16 networks run channels-last."""
    monkeypatch.setattr(layers, 'runs_channels_last',
                        lambda dtype, device: dtype == torch.bfloat16)


def _assert_close_bf16(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype != torch.bfloat16:
        torch.testing.assert_close(got, want, rtol=1.6e-2, atol=1e-5)
        return
    ulps = (got.contiguous().view(torch.int16).int()
            - want.contiguous().view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1
    assert float((ulps > 0).float().mean()) <= MAX_ULP_SHARE


def _layout_hooks(model):
    """Forward hooks recording whether each convolution's and norm's output
    is channels-last (or a map where the two layouts are one)."""
    seen = []

    def hook(module, args, out):
        ambiguous = out.shape[1] == 1 or out.shape[2] * out.shape[3] == 1
        seen.append((type(module).__name__, tuple(out.shape),
                     ambiguous or layers.is_channels_last(out)))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (layers.Conv2d, layers.InstanceNorm))]
    return seen, handles


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return module


def test_runs_channels_last_is_bf16_on_the_card():
    assert layers.runs_channels_last(torch.bfloat16, 'cuda')
    assert layers.runs_channels_last(torch.bfloat16, torch.device('cuda', 1))
    assert not layers.runs_channels_last(torch.float32, 'cuda')
    assert not layers.runs_channels_last(torch.bfloat16, 'cpu')
    assert not layers.runs_channels_last(torch.float32, 'cpu')


def test_eye_net_keeps_channels_last(channels_last):
    net = _seeded(EyeNet(compute_dtype=torch.bfloat16), 1)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)).bfloat16()
    head = torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32))
    with torch.no_grad():
        want = net.features(x.permute(0, 3, 1, 2).contiguous(), head)
        seen, handles = _layout_hooks(net)
        got = net.features(x.permute(0, 3, 1, 2), head)
    for h in handles:
        h.remove()
    assert len(seen) == 40 and all(ok for _, _, ok in seen), seen
    _assert_close_bf16(got, want)


def test_refine_net_keeps_channels_last(channels_last):
    net = _seeded(RefineNet(rnn_type='CLSTM', load_screen_content=True,
                            compute_dtype=torch.bfloat16), 3)
    rng = np.random.RandomState(4)
    heat = torch.from_numpy(rng.uniform(0, 1, (6, 72, 128)).astype(
        np.float32))
    screen = torch.from_numpy(rng.uniform(0, 1, (6, 72, 128, 3)).astype(
        np.float32)).bfloat16()
    outs = []
    for form in ('nchw', 'nhwc'):
        s = screen.permute(0, 3, 1, 2)
        s = s.contiguous() if form == 'nchw' else s
        seen, handles = _layout_hooks(net)
        with torch.no_grad():
            x = net.assemble_input(heat, s)
            bottleneck, skips = net.encode(x)
            states = net.init_state(2)
            seq = bottleneck.reshape((2, 3) + bottleneck.shape[1:])
            ys = []
            for t in range(3):
                y, states = net.bottleneck_step(seq[:, t], states)
                ys.append(y)
            out = net.decode(torch.stack(ys, 1).reshape(bottleneck.shape),
                             skips)
        for h in handles:
            h.remove()
        outs.append(out)
        if form == 'nhwc':
            assert layers.is_channels_last(x)
            assert all(layers.is_channels_last(k) for k in skips)
            assert all(ok for _, _, ok in seen), [s for s in seen
                                                  if not s[2]]
    _assert_close_bf16(outs[1], outs[0])


@pytest.mark.parametrize('shape,out_hw', [
    ((3, 16, 9, 16), (18, 32)), ((3, 256, 5, 8), (9, 16)),
    ((2, 32, 36, 64), (72, 128)), ((2, 4, 7, 5), (3, 11))])
def test_resize_nhwc_equals_nchw(shape, out_hw):
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                         ).bfloat16()
    want = layers.resize_bilinear(x, out_hw)
    got = layers.resize_bilinear(x.contiguous(memory_format=CL), out_hw)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


def test_cat_channels_keeps_channels_last():
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.normal(size=(3, 3, 8, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 1, 8, 8)).astype(np.float32))
    want = torch.cat([a, b], dim=1)
    assert torch.equal(layers.cat_channels([a, b]), want)
    assert layers.cat_channels([a, b]).is_contiguous()
    for pair in ([a.contiguous(memory_format=CL), b],
                 [b, a.contiguous(memory_format=CL)]):
        got = layers.cat_channels(pair)
        assert layers.is_channels_last(got)
        assert torch.equal(got, torch.cat(pair, dim=1))


def test_cat_channels_slices_a_batch_past_the_index_limit(monkeypatch):
    """Past ``CAT_INDEX_LIMIT`` elements the output is written slice by
    slice of the batch; with autograd it is one concatenation."""
    monkeypatch.setattr(layers, 'CAT_INDEX_LIMIT', 5 * 4 * 6 * 3)
    rng = np.random.RandomState(6)
    a, b = (torch.from_numpy(rng.normal(size=(7, c, 4, 6)).astype(
        np.float32)).contiguous(memory_format=CL) for c in (4, 2))
    want = torch.cat([a, b], dim=1)
    with torch.no_grad():
        got = layers.cat_channels([a, b])
    assert layers.is_channels_last(got) and torch.equal(got, want)
    a.requires_grad_(True)
    got = layers.cat_channels([a, b])
    got.sum().backward()
    assert torch.equal(got, want) and torch.equal(a.grad,
                                                  torch.ones_like(a))


@pytest.mark.parametrize('n,o,want', [
    (72, 36, (2, 2, 0)), (128, 64, (2, 2, 0)), (9, 5, (3, 2, 1)),
    (16, 8, (2, 2, 0)), (10, 4, None), (6, 1, (6, 6, 0))])
def test_pool_window(n, o, want):
    assert layers._pool_window(n, o) == want


def test_adaptive_max_pool_equals_torchs_with_its_gradient():
    """Values and gradients (ties included) of every input size up to 20
    and every output size, channels-last or not."""
    torch.manual_seed(7)
    for n in range(1, 21):
        for o in range(1, n + 1):
            x = torch.randint(-2, 3, (2, 3, n, n + 1)).bfloat16()
            g = torch.randn(2, 3, o, o).bfloat16()
            for inp in (x, x.contiguous(memory_format=CL)):
                xs = [inp.clone().requires_grad_(True) for _ in range(2)]
                want = F.adaptive_max_pool2d(xs[0], (o, o))
                got = layers.adaptive_max_pool(xs[1], (o, o))
                want.backward(g)
                got.backward(g)
                assert torch.equal(got, want), (n, o)
                assert torch.equal(xs[1].grad, xs[0].grad), (n, o)


def test_conv_keeps_channels_last_weights(channels_last):
    """Where the networks run channels-last a bf16 convolution keeps its
    cast weight channels-last, so even an NCHW input comes out
    channels-last; at float32 nothing changes."""
    torch.manual_seed(8)
    conv = layers.Conv2d(4, 8, 3, padding=1)
    x = torch.randn(2, 4, 6, 6).bfloat16()
    with torch.no_grad():
        y = conv(x)
        weight = conv._cast_cache[2][0]
        assert weight.is_contiguous(memory_format=CL)
        assert layers.is_channels_last(y)
        y32 = conv(x.float())
    assert y32.is_contiguous()


def _eve_batch(seed):
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    import os
    config = Config()
    config.import_json(os.path.join(os.path.dirname(__file__), '..',
                                    'configs', 'refine_net.json'))
    config.import_dict({'tpu_compute_dtype': 'bfloat16'})
    spec = eve_lib.EveSpec.from_config(config)
    model = eve_lib.init_model(spec, torch.Generator().manual_seed(seed),
                               device='cpu')
    batch = make_synthetic_batch(np.random.RandomState(seed), batch_size=1,
                                 sequence_len=2, eyes_size=64,
                                 frame_dtype=np.uint8)
    return model, eve_lib.batch_to_tensors(batch, 'cpu')


def test_eve_entry_chooses_the_layout(monkeypatch):
    """The EVE forward hands EyeNet and RefineNet channels-last frames where
    ``runs_channels_last`` holds, NCHW-contiguous ones on the CPU as it
    is, and both give the same outputs."""
    model, batch = _eve_batch(9)
    inputs = []
    hooks = [model.eye_net.cnn_layers.conv1.register_forward_hook(
                 lambda m, args, out: inputs.append(args[0])),
             model.refine_net.initial[0].register_forward_hook(
                 lambda m, args, out: inputs.append(args[0]))]
    outs = []
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(layers, 'runs_channels_last',
                                lambda dtype, device: True)
        inputs.clear()
        with torch.no_grad():
            outs.append(model(batch, output_predictions=True))
        patches, net_in = inputs
        for t in (patches, net_in):
            assert layers.is_channels_last(t) is forced
            assert t.is_contiguous() is not forced
    for h in hooks:
        h.remove()
    for k in ('PoG_px_initial', 'PoG_px_final', 'full_loss'):
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0, atol=0)


@pytest.mark.cuda
def test_captured_bf16_forward_replays_the_eager_one():
    """The gate's timed forward (``bench.inference.measure_inference`` with
    ``graph``): the bf16 flagship forward on the card, channels-last with
    its norm and heatmap kernels, captured as a CUDA graph, replays the
    eager forward's outputs bitwise."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from eve_tpu_torch.bench import common, inference
    device = torch.device('cuda')
    model = common.init_flagship(common.flagship_spec('bfloat16'),
                                 device).eval()
    batch, = common.make_batches(2, 3, device, n=1)
    out = {}

    def forward():
        out['y'] = common.infer(model, batch)

    with torch.inference_mode():
        want = common.infer(model, batch)
        graph, = inference._captured([forward], device)
        graph.replay()
        torch.cuda.synchronize()
    for got, ref in zip(out['y'], want):
        assert torch.equal(got, ref)
