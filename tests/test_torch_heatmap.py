"""The port's heatmap ops and kernel wrappers against eve_tpu, on the CPU.

The port's plain render and soft-argmax (the versions its CUDA kernels are
held against on the card) must match eve_tpu's jnp formulations and its
Pallas kernels run in interpret mode, in value and in gradient. On a CPU
tensor the wrappers and ``autograd.Function``s take the plain path and
launch nothing. The kernels themselves run only on the card (``cuda``
marker; ``chip_smoke.py`` holds them against the plain versions there).
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
               lambda x: tkern.RenderHeatmaps.apply(
                   x, 10.0, (128, 72), (1920.0, 1080.0))):
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
               lambda y: tkern.SoftArgmax.apply(y, (128, 72),
                                                (1920.0, 1080.0), 100.0)):
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
    assert build.library_path('heatmap_kernels') != path


@pytest.mark.cuda
@pytest.mark.parametrize('n', [0, 1, 17, 240])
def test_kernels_match_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (chip_smoke.py runs the kernels there)')
    tkern.reset_launch_counts()
    c = torch.from_numpy(_centres(n)).cuda()
    for sigma in (10.0, 3.0, 5.0):
        ours = tkern.render_heatmaps(c, sigma)
        torch.testing.assert_close(ours, tkern.make_heatmaps_plain(c, sigma),
                                   **RENDER_TOL)
    x = torch.from_numpy(_maps(n)).cuda()
    torch.testing.assert_close(tkern.soft_argmax(x),
                               tkern.soft_argmax_plain(x), **SOFTARGMAX_TOL)
    launched = 1 if n else 0
    assert tkern.LAUNCHES == {'render_heatmaps': 3 * launched,
                              'soft_argmax': launched}
