"""The port's heatmap ops and kernel wrappers against eve_tpu, on the CPU.

The port's plain render and soft-argmax (the versions its CUDA kernels are
held against on the card) must match eve_tpu's jnp formulations and its
Pallas kernels run in interpret mode, in value and in gradient. On a CPU
tensor the wrappers and the custom ops (``eve_tpu_torch::render_heatmaps``,
``eve_tpu_torch::soft_argmax``) take the plain path and launch nothing.
The multi-sigma render (three sigmas and a validity mask
in one launch) and the soft-argmax of 144 x 256 maps are held against
eve_tpu the same way. The kernels themselves run only on the card
(``cuda`` marker; ``chip_smoke.py`` holds them against the plain versions
there).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from eve_tpu.kernels import heatmap_kernels as jkern
from eve_tpu.ops import heatmap as jhm
from eve_tpu_torch.kernels import build
from eve_tpu_torch.kernels import heatmap_kernels as tkern
from eve_tpu_torch.ops import heatmap as thm

# Render: both sides compute the same float32 expression; exp differs by an
# ulp or so between XLA and torch, so 1e-6 relative plus 1e-7 absolute near
# the 1e-8 floor.
RENDER_TOL = dict(rtol=1e-6, atol=1e-7)

# Soft-argmax: the sums run in another order (pairwise in torch, a tree in
# XLA); 1e-5 relative and 1e-3 px absolute on a 1920 px screen.
SOFTARGMAX_TOL = dict(rtol=1e-5, atol=1e-3)

# The first torch.exp of a process on the CPU is now and then off by up to
# 1.5e-4 relative (an exp with ~13 correct bits), and every later call is
# exact to 6e-8: with the CPU build of torch 2.13 on an Intel Xeon with
# AVX-512, the first exp of 9216 values was off in 8 of 450 fresh
# processes, in 4 of 252 after an add, and the exp after a 4-value exp in
# none of 253. pytest imports this module before it runs any test, so this
# call is the process's first exp and no comparison below sees that error.
torch.exp(torch.linspace(-3.0, 0.0, 72 * 128))


def _centres(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-50, 1970, n),
                     rng.uniform(-50, 1130, n)], -1).astype(np.float32)


def _maps(n, seed=1, peaked=True):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, 72, 128)).astype(np.float32)
    if peaked:
        # A bump per map so the softmax is not flat: beta=100 then weighs
        # a few dozen pixels, as a refined heatmap does.
        yy, xx = np.mgrid[:72, :128]
        for i in range(n):
            cy, cx = rng.uniform(0, 72), rng.uniform(0, 128)
            x[i] += 0.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 50.0)
    return x


@pytest.mark.parametrize('n', [0, 1, 17])
@pytest.mark.parametrize('sigma', [10.0, 3.0, 5.0])
def test_render_matches_eve_tpu(n, sigma):
    c = _centres(n)
    ours = thm.make_heatmaps(torch.from_numpy(c), sigma).numpy()
    ref = np.asarray(jhm.make_heatmaps(jnp.asarray(c), sigma))
    assert ours.shape == (n, 72, 128)
    np.testing.assert_allclose(ours, ref, **RENDER_TOL)
    if n:
        pallas = np.asarray(jkern.pallas_make_heatmaps(
            jnp.asarray(c), sigma, interpret=True))
        np.testing.assert_allclose(ours, pallas, **RENDER_TOL)


@pytest.mark.parametrize('n', [0, 1, 17])
def test_soft_argmax_matches_eve_tpu(n):
    x = _maps(n)
    ours = thm.soft_argmax(torch.from_numpy(x)).numpy()
    ref = np.asarray(jhm.soft_argmax(jnp.asarray(x)))
    assert ours.shape == (n, 2)
    np.testing.assert_allclose(ours, ref, **SOFTARGMAX_TOL)
    pallas = np.asarray(jkern.pallas_soft_argmax(jnp.asarray(x),
                                                 interpret=True))
    assert pallas.shape == (n, 2)
    np.testing.assert_allclose(ours, pallas, **SOFTARGMAX_TOL)


def test_soft_argmax_bf16_input_matches_eve_tpu():
    x = _maps(17)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    # Same bf16 values on both sides: the bf16 rounding is the input's.
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xj.astype(jnp.float32)))
    ours = thm.soft_argmax_fast(xt).numpy()
    ref = np.asarray(jhm.soft_argmax(xj))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **SOFTARGMAX_TOL)
    pallas = np.asarray(jkern.pallas_soft_argmax(
        xj.astype(jnp.float32), interpret=True))
    np.testing.assert_allclose(ours, pallas, **SOFTARGMAX_TOL)


def test_render_grad_matches_jax_vjp():
    c = _centres(17)
    g = np.random.RandomState(2).normal(size=(17, 72, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jhm.make_heatmaps(x, 10.0), jnp.asarray(c))
    (ref,) = vjp(jnp.asarray(g))
    for fn in (lambda x: thm.make_heatmaps(x, 10.0),
               lambda x: torch.ops.eve_tpu_torch.render_heatmaps(
                   x, [10.0], None, [128, 72], [1920.0, 1080.0])[0]):
        ct = torch.from_numpy(c).requires_grad_(True)
        (ours,) = torch.autograd.grad(fn(ct), ct, torch.from_numpy(g))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)


def test_soft_argmax_grad_matches_jax_vjp():
    x = _maps(17)
    g = np.random.RandomState(3).normal(size=(17, 2)).astype(np.float32)
    _, vjp = jax.vjp(jhm.soft_argmax, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    for fn in (thm.soft_argmax,
               lambda y: torch.ops.eve_tpu_torch.soft_argmax(
                   y, [128, 72], [1920.0, 1080.0], 100.0)):
        xt = torch.from_numpy(x).requires_grad_(True)
        (ours,) = torch.autograd.grad(fn(xt), xt, torch.from_numpy(g))
        # The gradient is beta * screen px * p * (grid - expectation):
        # entries reach ~1e3, and the two frameworks' linspace grids differ
        # by up to 6e-8, so hold each entry to 1e-4 of the largest.
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_dispatchers_keep_leading_dims_and_launch_nothing_on_cpu():
    tkern.reset_launch_counts()
    c = torch.from_numpy(_centres(6).reshape(2, 3, 2))
    hm = thm.make_heatmaps_fast(c, 5.0)
    assert hm.shape == (2, 3, 72, 128)
    np.testing.assert_array_equal(hm.numpy(),
                                  thm.make_heatmaps(c, 5.0).numpy())
    pog = thm.soft_argmax_fast(hm)
    assert pog.shape == (2, 3, 2)
    np.testing.assert_array_equal(pog.numpy(), thm.soft_argmax(hm).numpy())
    assert tkern.LAUNCHES == {'render_heatmaps': 0, 'soft_argmax': 0}


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match='CPU or CUDA'):
        tkern.render_heatmaps(torch.zeros((2, 2), device='meta'), 10.0)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        tkern.soft_argmax(torch.zeros((2, 72, 128), device='meta'))


def test_history_scan_matches_eve_tpu():
    rng = np.random.RandomState(4)
    hm = rng.uniform(0, 1, (2, 5, 72, 128)).astype(np.float32)
    ts = (np.arange(5) * 1e8 + 1.0)[None].repeat(2, 0).astype(np.float32)
    ts[1, 3:] = 0.0  # padded frames are skipped
    valid = np.ones((2, 5), np.float32)
    valid[0, 1] = 0.0
    ours = thm.decayed_history_scan(torch.from_numpy(hm), torch.from_numpy(ts),
                                    torch.from_numpy(valid)).numpy()
    ref = np.asarray(jhm.decayed_history_scan(
        jnp.asarray(hm), jnp.asarray(ts), jnp.asarray(valid)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_library_name_is_keyed_on_source(tmp_path, monkeypatch):
    monkeypatch.setenv('EVE_TORCH_BUILD_DIR', str(tmp_path))
    path = build.library_path('heatmap_kernels')
    assert path.startswith(str(tmp_path))
    assert path.endswith('.so')
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'heatmap_kernels.cu').write_text('// edited\n')
    monkeypatch.setattr(build, 'CSRC_DIR', str(src))
    edited = build.library_path('heatmap_kernels')
    assert edited != path
    # A header beside the source is part of the key: adding or editing one
    # rebuilds, and an unchanged tree keeps its name.
    (src / 'hopper_async.cuh').write_text('#pragma once\n')
    with_header = build.library_path('heatmap_kernels')
    assert with_header != edited
    assert build.library_path('heatmap_kernels') == with_header
    (src / 'hopper_async.cuh').write_text('#pragma once\n// edited\n')
    assert build.library_path('heatmap_kernels') != with_header


def _masked_centres(n, seed=5):
    """Centres with a 0/1 mask; one NaN centre sits under a 0."""
    c = _centres(n, seed)
    mask = (np.random.RandomState(seed + 1).uniform(size=n) > 0.3).astype(
        np.float32)
    if n:
        mask[0] = 0.0
        c[0] = np.nan
    return c, mask


@pytest.mark.parametrize('n', [0, 1, 17])
def test_multi_sigma_render_with_mask_matches_eve_tpu(n):
    sigmas = (10.0, 3.0, 5.0)
    c, mask = _masked_centres(n)
    ct, mt = torch.from_numpy(c), torch.from_numpy(mask)
    for ours in (thm.make_heatmaps_multi_fast(ct, sigmas, multiplier=mt),
                 tkern.render_heatmaps(ct, sigmas, mt),
                 torch.ops.eve_tpu_torch.render_heatmaps(
                     ct, list(sigmas), mt, [128, 72], [1920.0, 1080.0])):
        assert ours.shape == (3, n, 72, 128)
        for s, sigma in enumerate(sigmas):
            ref = np.asarray(jhm.make_heatmaps(jnp.asarray(c), sigma)
                             * jnp.asarray(mask)[:, None, None])
            # NaN where the NaN centre is, as `hm * mask` gives.
            np.testing.assert_allclose(ours[s].numpy(), ref, **RENDER_TOL)
    if n:
        assert np.isnan(ours[:, 0].numpy()).all()
        assert np.isfinite(ours[:, 1:].numpy()).all()


def test_multi_sigma_dispatcher_keeps_leading_dims():
    tkern.reset_launch_counts()
    c = torch.from_numpy(_centres(6).reshape(2, 3, 2))
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])
    hm = thm.make_heatmaps_multi_fast(c, (10.0, 3.0), multiplier=mask)
    assert hm.shape == (2, 2, 3, 72, 128)
    for s, sigma in enumerate((10.0, 3.0)):
        np.testing.assert_array_equal(
            hm[s].numpy(),
            (thm.make_heatmaps(c, sigma) * mask[..., None, None]).numpy())
    np.testing.assert_array_equal(thm.make_heatmaps_fast(c, 3.0).numpy(),
                                  thm.make_heatmaps(c, 3.0).numpy())
    assert tkern.LAUNCHES == {'render_heatmaps': 0, 'soft_argmax': 0}


def test_multi_render_grad_matches_jax_vjp():
    sigmas = (10.0, 3.0, 5.0)
    c = _centres(17)
    mask = (np.arange(17) % 3 != 0).astype(np.float32)
    g = np.random.RandomState(6).normal(size=(3, 17, 72, 128)).astype(
        np.float32)

    def jax_multi(x):
        return jnp.stack([jhm.make_heatmaps(x, s) * jnp.asarray(mask)[:, None,
                                                                      None]
                          for s in sigmas])

    _, vjp = jax.vjp(jax_multi, jnp.asarray(c))
    (ref,) = vjp(jnp.asarray(g))
    ct = torch.from_numpy(c).requires_grad_(True)
    out = torch.ops.eve_tpu_torch.render_heatmaps(
        ct, list(sigmas), torch.from_numpy(mask), [128, 72],
        [1920.0, 1080.0])
    (ours,) = torch.autograd.grad(out, ct, torch.from_numpy(g))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)


def _big_maps(n, seed=7):
    """144 x 256 maps: 36,864 pixels, four times the serving map."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, 144, 256)).astype(np.float32)
    yy, xx = np.mgrid[:144, :256]
    for i in range(n):
        cy, cx = rng.uniform(0, 144), rng.uniform(0, 256)
        x[i] += 0.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 200.0)
    return x


@pytest.mark.parametrize('n', [1, 5])
def test_soft_argmax_over_old_cap_matches_eve_tpu(n):
    size = (256, 144)
    x = _big_maps(n)
    ref = np.asarray(jhm.soft_argmax(jnp.asarray(x), heatmap_size=size))
    pallas = np.asarray(jkern.pallas_soft_argmax(jnp.asarray(x),
                                                 heatmap_size=size,
                                                 interpret=True))
    np.testing.assert_allclose(pallas, ref, **SOFTARGMAX_TOL)
    for ours in (tkern.soft_argmax(torch.from_numpy(x), heatmap_size=size),
                 thm.soft_argmax_fast(torch.from_numpy(x).reshape(
                     (1, n, 144, 256)), heatmap_size=size)[0]):
        assert ours.shape == (n, 2)
        np.testing.assert_allclose(ours.numpy(), ref, **SOFTARGMAX_TOL)
        np.testing.assert_allclose(ours.numpy(), pallas, **SOFTARGMAX_TOL)


@pytest.mark.parametrize('masked', [False, True], ids=['plain', 'masked'])
def test_render_op_passes_opcheck(masked):
    """Schema, fake (meta) implementation, autograd registration and
    AOTAutograd with dynamic shapes, with and without the multiplier."""
    c = torch.from_numpy(_centres(5)).requires_grad_(True)
    sigmas, mask = [10.0], None
    if masked:
        sigmas, mask = [10.0, 3.0, 5.0], torch.tensor([1., 0., 1., 1., 0.])
    torch.library.opcheck(torch.ops.eve_tpu_torch.render_heatmaps.default,
                          (c, sigmas, mask, [128, 72], [1920.0, 1080.0]))


def test_soft_argmax_op_passes_opcheck():
    x = torch.from_numpy(_maps(3)).requires_grad_(True)
    torch.library.opcheck(torch.ops.eve_tpu_torch.soft_argmax.default,
                          (x, [128, 72], [1920.0, 1080.0], 100.0))


def test_op_gradients_equal_the_plain_formulas():
    """On the CPU the ops' backward (the plain formula's gradient, as the
    kernels' former ``autograd.Function``s computed it) equals autograd of
    the plain versions bitwise."""
    c = torch.from_numpy(_centres(17))
    mask = torch.from_numpy((np.arange(17) % 3 != 0).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(8).normal(
        size=(3, 17, 72, 128)).astype(np.float32))
    grads = []
    for fn in (lambda x: torch.ops.eve_tpu_torch.render_heatmaps(
                   x, [10.0, 3.0, 5.0], mask, [128, 72], [1920.0, 1080.0]),
               lambda x: tkern.make_heatmaps_multi_plain(
                   x, (10.0, 3.0, 5.0), mask)):
        x = c.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x), x, g)[0])
    assert torch.equal(*grads)
    maps = torch.from_numpy(_maps(17))
    gp = torch.from_numpy(np.random.RandomState(9).normal(
        size=(17, 2)).astype(np.float32))
    grads = []
    for fn in (lambda x: torch.ops.eve_tpu_torch.soft_argmax(
                   x, [128, 72], [1920.0, 1080.0], 100.0),
               tkern.soft_argmax_plain):
        x = maps.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x), x, gp)[0])
    assert torch.equal(*grads)


def test_fake_ops_give_shapes_and_launch_nothing():
    """Under fake tensors (as ``torch.export`` traces) the ops give their
    output's shape and type from the fake implementation; no launch is
    counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tkern.reset_launch_counts()
    with FakeTensorMode():
        c = torch.empty((80, 2))
        maps = tkern.render_heatmaps(c, (10.0, 3.0), torch.empty(80))
        pog = tkern.soft_argmax(torch.empty((80, 72, 128),
                                            dtype=torch.bfloat16))
    assert maps.shape == (2, 80, 72, 128) and maps.dtype == torch.float32
    assert pog.shape == (80, 2) and pog.dtype == torch.float32
    assert tkern.LAUNCHES == {'render_heatmaps': 0, 'soft_argmax': 0}


@pytest.mark.parametrize('n,quads,sms,want', [
    (80, 2304, 132, 2),      # the serving shape: 160 CTAs
    (132, 2304, 132, 1),
    (240, 2304, 132, 1),
    (17, 2304, 132, 8),
    (1, 2304, 132, 8),
    (40, 2304, 132, 4),
    (1, 9216, 132, 8),       # 144 x 256
    (1, 600, 132, 2),        # small maps: a quad for every thread
    (1, 100, 132, 1),
])
def test_soft_argmax_cluster_size(n, quads, sms, want):
    assert tkern.soft_argmax_cluster_size(n, quads, sms) == want


@pytest.mark.parametrize('s,n,sms,want', [
    (1, 80, 132, 24),        # the serving shape: 240 CTAs
    (3, 80, 132, 72),        # the label path: 240 CTAs
    (1, 240, 132, 72),
    (1, 17, 132, 5),
    (1, 1, 132, 1),
])
def test_render_rows(s, n, sms, want):
    assert tkern.render_rows(s, n, 72, sms) == want


@pytest.mark.cuda
@pytest.mark.parametrize('n', [0, 1, 17, 80, 240])
def test_kernels_match_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (chip_smoke.py runs the kernels there)')
    tkern.reset_launch_counts()
    c = torch.from_numpy(_centres(n)).cuda()
    for sigma in (10.0, 3.0, 5.0):
        ours = tkern.render_heatmaps(c, (sigma,))
        assert ours.shape == (1, n, 72, 128)
        torch.testing.assert_close(ours[0],
                                   tkern.make_heatmaps_plain(c, sigma),
                                   **RENDER_TOL)
    cm, mask = _masked_centres(n)
    cm, mask = torch.from_numpy(cm).cuda(), torch.from_numpy(mask).cuda()
    sigmas = (10.0, 3.0, 5.0)
    torch.testing.assert_close(
        tkern.render_heatmaps(cm, sigmas, mask),
        tkern.make_heatmaps_multi_plain(cm, sigmas, mask), equal_nan=True,
        **RENDER_TOL)
    x = torch.from_numpy(_maps(n)).cuda()
    torch.testing.assert_close(tkern.soft_argmax(x),
                               tkern.soft_argmax_plain(x), **SOFTARGMAX_TOL)
    big = torch.from_numpy(_big_maps(min(n, 17))).cuda()
    torch.testing.assert_close(
        tkern.soft_argmax(big, heatmap_size=(256, 144)),
        tkern.soft_argmax_plain(big, heatmap_size=(256, 144)),
        **SOFTARGMAX_TOL)
    launched = 1 if n else 0
    assert tkern.LAUNCHES == {'render_heatmaps': 4 * launched,
                              'soft_argmax': 2 * launched}
